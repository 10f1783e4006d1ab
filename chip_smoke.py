#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tae_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device: refuses to run without CUDA; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for fp32 matmuls and convolutions;
2. build: compiles the kernels in ``tae_tpu_torch/csrc/`` with nvcc for
   sm_90a and prints the seconds and ptxas's registers and spills of every
   kernel; fails if an instantiation of the register-resident attention
   bodies, forward (K2, K15, K16, and its int8-output form behind K7 / K8),
   flat-row (K6, K9) or backward (K10, K17), of their fp32 CUDA-core
   bodies (``F32_BODIES``), or of the int8 GEMM body's
   products (K4, K5's fc1 and fc2, and with the packed int4 weight K12,
   K13's fc1 and fc2), spills, if the int4 products' SASS lacks ldmatrix or
   touches local memory in its innermost tensor-core loops, if a
   cluster body's SASS (K7 / K8's, and the flat-row body's int8 form) lacks
   one of its two cluster barriers, if an instantiation of the LayerNorm
   row kernels' register bodies (K3, K11) spills at a registered width, or
   if the SASS of K4's and K5's finish passes or of K1's forward differs
   from the fingerprints recorded for this nvcc release (``FINISH_SASS``);
3. kernels: holds each of the eighteen kernels against its plain PyTorch version
   on the card at the slices' shapes, with the tolerances below, and prints
   the median time of both (CUDA events), the least time the card could
   take for the same work (the larger of bytes / 3.35 TB/s and operations /
   the tensor cores' peak), and the time of the one PyTorch call that
   computes the same function where there is one (a yardstick only). The
   four tiny-N / int8-output attention entries are also timed beside the
   per-image attention kernel (plus the plain per-row quantize) at the same
   shape: the measurements the dispatch rule of
   ``tae_tpu_torch.ops.attention.attention_route`` rests on. K7 and K8 (on
   the forward body from 16 tokens, their row epilogue shared over a
   thread-block cluster) are also held at ragged token counts, head counts
   whose last cluster rank takes fewer heads, rows whose largest output lies
   in the last rank's heads and all-zero rows, their launch plan against the
   library's, and K7's fp32 output against K2's on the same input (the
   same-o check). K6 and K9 (the flat-row body) are timed at p128's shape
   at B = 64, 8 and 1, their plan held against the library's with the
   clusters or blocks the card holds at once. The int4
   kernels (K12 ``int4_matmul_fused``, K13 ``int4_mlp``) run at the few-row
   shapes int4 serving is for (width 2560, 4 to 256 rows) and at the p16
   shape, beside the int8 kernels and a dequantize + bf16 product at the
   same shapes, K12 bit for bit; the codebook search (K14 ``nearest_code``)
   at 16384 x 256 latents against 8192 codes beside
   ``torch.cdist(...).argmin``, and at the
   4096- and 16384-wide latents of the vocab-4096 / -16384 configs; the
   unpacked attention of a qk_norm block (K16, both forms; K17) beside SDPA's
   forward and backward; K4's ``q8_out`` and in-kernel-quantize forms, and the
   int8-input attention K15 on K4's ``q8_out`` output, beside the default
   int8 route (K4, then K7); the attention backward (K10, K17) also at the
   token counts where its bf16 body's tiles and row ranges end
   (``BWD_EDGES``) and, in fp32, either side of its tiled body's rule and
   at its key chunks' edges (``F32_BWD_EDGES``), its fp32 launch held
   against ``bwd_f32_plan``, two runs bit-equal at every shape, and timed
   between CUDA events as SDPA's backward is (fp32 at p16's, p32's and
   p64's shapes); the fp32 forms of K6-K9 (the flat-row body's CUDA-core
   form; K7 / K8 from 33 tokens on the fp32 forward's tiled body) at p128's,
   p16's and p32's shapes beside SDPA in fp32 and K2 fp32 + the plain
   quantize, their plans held against the library's, K8 equal to K9 on the
   same bytes; K4 (plain, ``ln_out``, ``q8_out``)
   and K5 also at p128's width at 256, 32 and 4 rows and at p32's shapes,
   and at the edges of the int8 GEMM body's tiles (1, 17 and 129 rows, N 8
   past a tile, K 16 past a ring step); K3 at p128's width beside an empty
   kernel on its grid, and K11 at ``p128_train``'s (32, 2560) too, each
   with its launch plan held against the library's, K11 as two device
   launches a call; K4's first case (p16's qkv) runs ``K4_REPEATS`` more
   times, each output bit-equal to the first (ROADMAP C6);
4. paths (``PATHS``): for each model, built at full width with weights from
   ``torch.Generator("cuda").manual_seed(0)``, the bf16 and / or the int8
   (w8a8) ``Tokenizer`` answers encode, decode and reconstruct requests;
   checks shapes, finiteness, every kernel's launch count on every request,
   each output against the same model run with ``backend="reference"``, and
   the int8 outputs against the bf16 tokenizer's on the same weights. The
   int8 tokenizers are also timed with the int8-output attention forced on
   and off (``attn_q8``). ``p16_int8_qkvq8`` serves the p16 model in int8
   with ``qkv_q8=True`` (K4's q8_out form and K15 in every block), against
   the default int8 tokenizer too, timed with the switch on and off.
   ``p128_int4`` serves
   ``tae_patch128_vocab4096_px256`` in int4 (w4a8) at full width and depth
   on the same weights, ``p16_int4`` ``tae_patch16_vocab256_px256`` at depth
   2 + 2. ``vq_p16``: the same p16 model at depth 2 + 2 with the VQ
   bottleneck (``quantize=True``, 8192 codes): ``encode_discrete`` at every
   batch size with the codebook search's launch counted, its ids against
   ``backend="reference"`` on the same latents, ``decode_discrete`` against
   ``decode`` of the codebook rows bit for bit, and one train step through
   ``make_train_step``; ``vq_p64`` the same on the p64 model's 4096-wide
   latents. ``qknorm_blocks``: qk_norm block stacks (no registered model has
   one) driven through ``nn.vit.blocks_apply``, a serving forward and one
   AdamW train step each, launch counts and outputs and gradients against
   ``backend="reference"``. ``vq_p16_f32`` serves vq_p16's model in fp32;
   ``p128_f32`` serves ``tae_patch128_vocab4096_px256`` at depth 2 + 2
   through ``Tokenizer(dtype=torch.float32)`` (K6 in fp32 in every block),
   and its int8 tokenizer with fp32 activations (K9 in fp32), each call's
   launches checked, against ``backend="reference"``. Every ``Tokenizer``
   serves from CUDA graphs (the default on the card): a shape's first
   request runs eagerly, its second captures, the later ones (the timed
   ones) replay, each counting one request's launches, as the graph cache
   adds them; so for every graph the kernel nodes, read from the graph,
   are held by name and count against the library kernels of the same
   request run eagerly under ``torch.profiler``, whose launches the
   wrappers count (``check_replay``). ``graphs`` (on the tokenizers of
   ``GRAPH_PATHS``, reused): at every batch size, a graph tokenizer against
   one with ``cuda_graphs=False`` on the same model, outputs and ids bit for
   bit, host wall per request (medians in turns), device time (a replay
   alone between CUDA events; a traced request's kernels summed), peak
   memory, launches a request, the memory the graphs hold,
   and the host time of the graph cache's check that the model is
   unchanged;
5. training (``train_bf16``): ``tae_patch16_vocab256_px256`` at full width
   and depth, fp32 parameters, bf16 compute, AdamW, through
   ``make_train_step``: one step at B = 8 against a second copy of the model
   with ``backend="reference"`` (loss and every gradient tensor); eight steps
   at B = 64 on one batch with the launch counts of the four training
   entries checked on every step, finite and decreasing losses; a checkpoint
   after step 4 loaded into a fresh model and optimizer, whose step 5 equals
   the running state's bit for bit; ``accum_iter = 2`` against 1; steps with
   ``remat=True``; step time, images per second and peak memory for both;
   the selective remat policies (``train_policies``): from one saved state
   one eager step in each of the four remat modes (``False``, ``True``,
   ``"dots"``, ``"dots_no_batch"``), each bit-equal to ``remat=False``'s
   (loss, gradient norm, parameters, moments), the policies at
   ``remat=True``'s launches, the allocated peaks ordered ``True`` <
   ``"dots"`` = ``"dots_no_batch"`` < ``False``, a traced step's cuBLAS
   launches (the policies rerun none), then steps under each policy from
   graphs, timed; ``scaler``: ``train.scaler.DynamicLossScale`` on the last
   step's gradients eagerly and from a captured graph (a finite step, the
   growing one, one with an ``inf``), bit-equal, the graph's nodes the eager
   call's kernels, the host µs of both.
   ``p128_train``: one step of ``tae_patch128_vocab4096_px256`` at depth
   2 + 2 through the tiny-N attention entry, gradients against
   ``backend="reference"``. ``train_f32``: ``tae_patch16_vocab256_px256`` at
   depth 2 + 2 under the FP32 policy (K10 and K2's LSE form in fp32), one
   step at B = 8 against ``backend="reference"``, steps at B = 64 with
   their launches checked and timed. Every step above from the second of a
   shape on is a CUDA graph replay (``make_train_step``'s default on the
   card); every graph that a train step or a driver's eval pass captures
   in this run is held, right after its capture, against its key's work run
   eagerly under ``torch.profiler`` on the same state, put back after:
   the graph's kernel nodes against the eager call's library kernels by
   name and count, and the launches a replay adds against those the
   wrappers counted (``install_graph_checks``; each phase prints how many
   it checked). ``train_graphs``: ``train_bf16``'s recipe at B = 64, ``rec19k``'s
   and ``p128_train``'s, each with fused AdamW and with bf16 moments (K18),
   eight steps eagerly and eight from a graph from one seed, the learning
   rate switching at step 4: each step's loss, gradient norm and learning
   rate equal, every parameter, moment and step count bit-equal after the
   last; the graph's kernel nodes against a traced eager step's kernels;
   host wall eager and graph, a replay's device time, peak memory, and the
   host time of the optimizer's host part and of the graph's model check;
   fused AdamW with the learning rate as a float against a tensor;
6. drivers (``drivers``): the user's entry points on
   ``tae_patch16_vocab256_px256`` at full width and depth, on a webdataset
   shard and an ImageFolder made by ``tae_tpu_torch.data.fake``: the
   calibration pass of ``Tokenizer.from_checkpoint(calib_images=)`` (its
   statistics against ``backend="reference"``, its K1 / K2 fp32 launches a
   batch), ``cli.encode`` in bf16, int8 and int4 (shards bit-equal to
   ``Tokenizer.encode`` of the same batches, launches a batch),
   ``cli.evaluate`` against ``--attn_backend reference``, ``cli.train`` with
   an eval, both checkpoints and a ``--resume_auto`` run (launches every
   step), ms per step, and the cost of reading the step metrics; then
   ``cli.train`` (with two evals, the second replaying the eval pass's
   graph) and ``cli.evaluate`` by default (from graphs) and with
   ``--cuda_graphs off``: the same step losses, eval losses and returned
   loss, and the peak memory of both modes. ``convergence``: the
   convergence run's model (``tae_patch16_vocab16_px256``, 15 + 15, B = 64)
   on a small structured corpus from ``data.fake`` (2 shards of 320 images,
   128 val images, 288 px): ``cli.evaluate`` of the seeded weights, then
   ``tae_tpu_torch.scripts.convergence``'s chunk loop through ``cli.train``
   to 300 iterations in two chunks (``--resume_auto``), every launch
   counted, every logged loss finite, the eval MSE at 300 at most half of
   iteration 0's; then ``scripts.quant_accuracy``'s six modes on the
   trained checkpoint through the JAX script's forward (the exact softmax;
   launches counted, latent relative error ≤ 0.2 and MSE ≤ 3× bf16's), each
   quantized tokenizer's encode and decode against ``backend="reference"``
   at 4e-2, and the bf16 tokenizer's serving MSE ≤ 1.1× the exact bf16
   row's;
7. downstream: the recognition and segmentation trunks (ViT-Base, width
   768, 12 heads of 64, 256 tokens) on the frozen p16 encoder. The kernel
   phase holds K2 (exact and LSE forms) and K10 at 12 heads, and K1, its
   stats form and K11 at width 768 (rec19k's and seg_p16's rows), against
   their plain versions and times them. ``rec19k``: the JAX bench's
   ``train_rec19k_int8enc_mb64`` recipe (the int8 encoder, the 19167-class
   head, remat), one step at B = 8 against ``backend="reference"`` (loss
   and every gradient), eight steps at B = 64 with each step's launches
   checked, step time, images per second and peak memory. ``seg_p16``: the
   segmenter on the bf16 encoder at B = 8, ``out`` and ``aux`` and one step
   against ``backend="reference"``, steps with their launches checked.
   ``downstream``: the three downstream drivers through their ``main`` on
   fake data (the in19k shard with the int8 encoder; in1k from its
   checkpoint with the head swapped, against ``--attn_backend reference``;
   segmentation on COCO instances against ``--attn_backend reference``,
   ``--resume`` for a second epoch, and the first epoch's checkpoint run
   outside the driver through the kernels and the plain versions), each
   step's launches checked; the in19k, in1k and segmentation drivers again
   by default and with ``--cuda_graphs off``: the same step losses and log
   rows (eval loss and accuracy, IoU), and the peak memory of both modes;
8. the multi-GPU layer and K18 (AdamW with bf16 moments, the port's own
   kernel: no TPU kernel behind it). The kernel phase runs K18 on the full
   p128 model's parameter list (3.73 B fp32 parameters and gradients, bf16
   moments) three times against its plain version, bit for bit, and times
   it beside its bound (20 bytes a parameter) and
   ``torch.optim.AdamW(fused=True)`` with fp32 moments. ``train_p128_fsdp``:
   the process sets up its own NCCL world of 1 and a (1, 1, 1) mesh; at
   2 + 2 blocks one step under ``parallel.shard_model`` (FSDP2) is held bit
   for bit against the unwrapped model and K18, and against
   ``backend="reference"`` with K18's plain version (loss 1e-3, gradients
   2.5e-2); then the full model (22 + 22 blocks, width 2560) takes three
   steps at B = 64 with every launch counted (K18 once a step): step time,
   images per second, peak memory beside the 44.81 GB floor, and the same
   model's peak with fp32 moments. ``world2``: two gloo ranks on the one
   card (FSDP2's collectives on CUDA tensors) take the 2 + 2 step of the
   global batch against one process. ``tensor2``: two gloo ranks on the
   one card on a (1, 1, 2) mesh, every block split over ``tensor`` (each
   rank runs the kernels on its own heads): the flagship at full width and
   depth (8 heads a rank) one ``train_bf16``-recipe step with bf16 moments
   at B = 16, p128 at 2 + 2 blocks (16 heads of 80 a rank, K6) one step at
   B = 64 (gradients clipped), and a bf16 ``Tokenizer`` encoding 8 p16
   images, each against this process's unsplit run (loss, gradient norm,
   latents), each step also against the same step unsplit in the rank
   (leaves' updates and first moments) beside two controls that must miss
   their limits (peer sums of proj / fc2 rounded to bf16; the gradient
   peer sum ahead of qkv / fc1 dropped), each rank's launches counted, the
   wall times printed. ``drivers_mesh``:
   ``cli.train`` with ``WORLD_SIZE=1 --mesh_fsdp 1`` against the same
   driver without a mesh, at 2 + 2 blocks, losses and launches per step;
9. prints each phase's seconds on a ``[time]`` line, a JSON line with
   every kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

# (model, {depth overrides}, paths driven: tag -> quantization). p16 is the
# slice of the first two bring-ups; p128 and p32 run at full width and depth;
# p64 holds the wide int8 attention at 16 tokens and head dim 80 at a reduced
# depth (its blocks are p128's width).
PATHS = (
    ("tae_patch16_vocab256_px256", {},
     {"bf16": None, "int8": "int8", "p16_int8_qkvq8": "int8_qkv_q8"}),
    ("tae_patch128_vocab4096_px256", {},
     {"p128_bf16": None, "p128_int8": "int8", "p128_int4": "int4"}),
    ("tae_patch32_vocab1024_px256", {}, {"p32_int8": "int8"}),
    ("tae_patch64_vocab4096_px256", dict(depth=2, decoder_depth=2),
     {"p64_int8": "int8"}),
    # the int4 kernels at 256 tokens (M = 16384 rows) behind the per-image
    # int8-output attention; depth cut to keep the run's time
    ("tae_patch16_vocab256_px256", dict(depth=2, decoder_depth=2),
     {"p16_int4": "int4"}),
)
# the VQ paths: the p16 model with the bottleneck, and p64's 4096-wide
# latents (K14 tiled over V), depth cut (the codebook search does not depend
# on depth)
VQ_PATHS = {
    "vq_p16": ("tae_patch16_vocab256_px256",
               dict(depth=2, decoder_depth=2, quantize=True,
                    codebook_size=8192)),
    "vq_p64": ("tae_patch64_vocab4096_px256",
               dict(depth=2, decoder_depth=2, quantize=True,
                    codebook_size=8192)),
}
# The VQ paths whose train step draws its codebook from the step's latent
# rows with replacement. At vq_p16 (2048 rows 256 wide, 8192 codes) about
# four noisy copies of each row compete for it: rivals close enough that a
# plain version which skips rounding the fp32 codebook to the latents' dtype
# picks other ids than the kernel, and the check must see that. vq_p64 has
# 8192 codes for 1024 serving rows and draws distinct rows, the other codes
# far from every row: noisy copies of its 4096-wide rows made near-ties that
# two correct searches broke apart on more rows than VQ_ID_SHARE allows.
VQ_STEP_RIVALS = {"vq_p16"}
# The fp32 path: vq_p16's model (2 + 2 blocks, 8192 codes) with fp32
# parameters and activations, through the CUDA-core forms of K2 (2 per
# encode) and K14 (1 per encode_discrete)
VQ_F32_PATH = "vq_p16_f32"
# fp32 latents and reconstructions against backend="reference" on the same
# card, relative Frobenius error: both compute in fp32 and differ only in
# summation order and the last bits of exp / rsqrt, through 2 + 2 blocks
# (measured on an H100: 3.9e-7 to 9.1e-7; the bound leaves 10x)
F32_SLICE_REL_TOL = 1e-5
# The fp32 training path: train_bf16's model and recipe at depth 2 + 2 under
# the FP32 policy (fp32 parameters, activations and compute): K10 and K2's
# LSE form in fp32, 4 each a step
TRAIN_F32_PATH = "train_f32"
TRAIN_F32_STEPS = 3
# Its step against backend="reference" on the same card: fp32 on both sides,
# differing only in summation order and the last bits of exp and rsqrt, as
# F32_SLICE_REL_TOL; the loss is one such forward, a gradient also sums over
# the B x N = 2048 rows of the step's batch, so 10x the slice's bound
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_GRAD_REL_TOL = 1e-4
# The fp32 serving path: tae_patch128_vocab4096_px256 at depth 2 + 2 through
# Tokenizer(dtype=torch.float32): K6 in fp32 (the flat-row body's CUDA-core
# form) in every block; its int8 tokenizer with fp32 activations runs K9 in
# fp32
P128_F32_PATH = "p128_f32"
BATCHES = (1, 8, 64)         # encode / decode request sizes
KERNEL_BATCH = 64            # batch of the kernel-vs-plain shapes
TIMED_REPS = 20              # kernel timings: launches per replayed graph
GRAPH_REPLAYS = 7            # ... and the median of this many replays
REQUEST_REPS = 3             # slice timings: median of this many requests
# requests of a shape before its graph replays: the eager one, the capture
GRAPH_WARM = 2
# the graphs phase: paths, and requests of each mode a round, in turns
GRAPH_PATHS = ("bf16", "int8", "p128_bf16", "p128_int8", "p128_int4",
               "p32_int8", "p16_int8_qkvq8", "vq_p16")
GRAPH_ROUNDS, GRAPH_PER_ROUND = 4, 6
UNCHANGED_REPS = 200         # ... and the graph cache's model check, timed
TRACE_TRIES = 3              # profiler sessions for one traced request
# ... each first pausing and running TRACE_WARM small kernels, then the
# request inside a range of this name
TRACE_WARM, TRACE_PAUSE_S, TRACE_RANGE = 64, 0.02, "chip_smoke.request"
# ROADMAP C6: K4's qkv case called again this often, each output bit for bit
K4_REPEATS = 10

# Kernel vs plain on the same card and inputs. Both compute in fp32 and
# round once; they differ only in fp32 summation order and in the last bit
# of exp/rsqrt, which in bf16 can flip one output rounding (one ulp is 2^-8
# relative, so 1e-2 allows about two) and in fp32 stays near 1e-6.
TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2),
       "float32": dict(atol=2e-5, rtol=1e-4)}
# Whole slice, kernels vs plain versions on the card, relative Frobenius
# error: the per-kernel bf16 rounding flips above feed through 15 residual
# blocks per half, each adding bf16-rounded matmul outputs of its own. A
# deeper model adds flips with every block: its bound is this one times
# depth / 15 (slice_tol).
SLICE_REL_TOL = 2e-2
SLICE_TOL_DEPTH = 15
# int8 kernels vs their plain versions. Both round the same fp32 values to
# codes; the values can differ in their last bits (summation order of the
# LayerNorm statistics, tanhf), so one within that of a rounding tie lands
# on the neighbouring code: codes may differ by 1 on at most
# CODE_FLIP_SHARE of the elements. Scales are max-reductions of such
# values (rtol 1e-5). The float outputs follow TOL.
CODE_FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-5
# K5 requantizes its hidden activation inside: a hidden code on a rounding
# tie flips and moves its whole output row, and so that row's chained LN
# scale, by one hidden quantization step (measured: up to 2.7e-4 relative,
# on 3-5 rows of 16384).
MLP_SCALE_RTOL = 1e-3
# The int8-output attention entries (K7-K9) in bf16: the P.V product takes p
# rounded to bf16, and the fp32 p of kernel and plain version differ in their
# last bits (summation order of the scores), so a p within that of a bf16
# rounding boundary rounds to the neighbouring value on one side. One such
# flip moves that head's outputs of that row by up to 2^-7 * (p / l) * |v|,
# and so the row's scale where its largest output sits in that head
# (measured at B = 64: 0.2% of the rows beyond SCALE_RTOL, the worst by
# 6e-3 relative; no code off by more than one). Scales agree to SCALE_RTOL
# on all but ATTN_SCALE_SHARE of the rows and to ATTN_SCALE_RTOL (2^-7 times
# |v| / max|o| up to 2.5) on every row. In fp32 p is not rounded and the
# scales agree to SCALE_RTOL throughout.
ATTN_SCALE_SHARE = 1e-2
ATTN_SCALE_RTOL = 2e-2
# int8 tokenizer vs the bf16 tokenizer on the same weights, relative
# Frobenius error: w8a8 quantization noise through 15 blocks per half (the
# JAX package's tests accept 0.03-0.05 on 2-3 layer models).
INT8_VS_BF16_TOL = 0.1
# The int8 slice, kernels vs plain versions on the card: the bf16 slice's
# rounding flips (attention and the bf16 casts are the same code), each of
# which also moves int8 codes in the layers after it (measured 0.018-0.021).
INT8_SLICE_REL_TOL = 4e-2
# The int4 kernels. K12: kernel and plain version add the same exact terms
# (int32 group sums times fp32 group scales) in the same order with every
# product and sum rounded separately, so fp32 outputs agree to the last bits
# (W4_FP32_TOL allows a couple of ulps); bf16 outputs round the same fp32
# value once (TOL). K13 adds tanhf, whose last bit differs between the
# kernel and torch.tanh (1e-5 in fp32), and requantizes its hidden
# activation: a hidden code on a rounding tie flips against the plain
# version and moves its whole output row by one hidden step times an fc2
# weight. Rows beyond the fp32 bound are counted: at most
# MLP4_FLIP_ROW_SHARE of them (at least one), none off by more than
# MLP4_FLIP_REL of the largest output.
W4_FP32_TOL = dict(atol=1e-6, rtol=1e-6)
MLP4_FP32_TOL = dict(atol=1e-5, rtol=1e-5)
MLP4_FLIP_ROW_SHARE = 1 / 256
MLP4_FLIP_REL = 1e-2
# K14: ids equal to the plain version's on all but this share of the rows
# (both add the same fp32 products in another order, so only a near-tie
# falls the other way), and where they differ the chosen code's squared
# distance (fp64) within VQ_NEAR_TIE_RTOL of the plain version's.
VQ_ID_SHARE = {"bfloat16": 1e-3, "float32": 0.0}
VQ_NEAR_TIE_RTOL = 1e-4
# int4 tokenizer vs the bf16 tokenizer on the same weights: a coarser code
# than int8 (the JAX package expects 3-5x the int8 error). Measured on
# seeded random weights: 0.134-0.175 through p128's 22 + 22 blocks (int8:
# 0.025-0.026, so 5-7x), 0.058-0.083 through 2 + 2 blocks of p16.
INT4_VS_BF16_TOL = 0.25
# The int4 slice, kernels vs plain versions on the card: the int8 slice's
# causes (the same attention, LN and rounding code; measured 0.018-0.025 at
# p128 against 0.022-0.025 in int8).
INT4_SLICE_REL_TOL = 4e-2
# K15's P.V product takes p rounded to bf16, as its plain version does; the
# fp32 p of the two differ in their last bits (summation order of the
# scores), so a p within that of a bf16 rounding boundary rounds one ulp
# (2^-7 of p at most) the other way, and the row's output moves by up to
# 2^-7 * (p / l) * |v|: at most P_FLIP_REL * max|v| however many flip. With
# the q8_out output of a product as input the scores span tens, one p carries
# most of a row, and such a flip exceeds TOL (measured 0.0625 on outputs of
# size ~8 at B = 64).
P_FLIP_REL = 2.0 ** -7
# K17 in bf16 rounds P and dS to bf16 ahead of its last three products (2^-9
# relative each), where its plain version keeps the JAX body's fp32
# throughout: each output is a sum of N such terms of both signs, held as a
# relative Frobenius error per output tensor.
K17_BF16_REL = 1e-2
# The int8 tokenizer with qkv_q8 on against the default int8 tokenizer on the
# same weights, relative Frobenius error: the qkv activation is quantized to
# int8 (one scale per row and 512 columns) on one side and kept in bf16 on
# the other, one more w8a8-sized rounding per block through 15 blocks per
# half; each side is within INT8_VS_BF16_TOL of bf16.
QKV_Q8_VS_INT8_TOL = 0.1

# The training kernels. K11's dw / db sum all rows in fp32 in chunk order and
# round once to the weight's dtype; the plain version sums in another order.
# A sum of M terms of size ~1 carries an fp32 error of about sqrt(M) * 6e-8
# and, in bf16, one rounding of a value of size ~sqrt(M): atol is TOL's times
# sqrt(M) / 8 in bf16 (2^-8 of |sum| ~ 128 at M = 16384 is 0.5: a flipped
# rounding, seen on a few columns) and times sqrt(M) in fp32.
# K10 in bf16 rounds P and dS to bf16 ahead of its last three products, the
# plain version at the same points; a last-bit difference of the fp32 values
# (summation order, expf) flips one such rounding and moves one term of a sum
# of N by 2^-9 of itself, so the outputs follow TOL. LSE, mean and rstd are
# fp32 on both sides: summation order only.
STATS_TOL = dict(atol=1e-5, rtol=1e-5)
# One train step, kernels vs backend="reference" on the same weights and
# batch, per parameter tensor, relative Frobenius error of the fp32
# gradients. The forward differs by the slice's rounding flips (SLICE_REL_TOL
# through 15 + 15 blocks); the backward adds its own in every block, and the
# reference backward (autograd of the plain forward) rounds P once and dS
# never, where the kernel rounds both to bf16. Measured at B = 8 on an H100:
# 0.0089 at the worst tensor (the patch embedding's weight, the deepest
# gradient) through 15 + 15 blocks, 0.0089 through p128's 2 + 2; losses
# 3.5e-5 apart. The bounds leave about 3x; a backward off by 5% in one
# kernel's output exceeds them (PERF.md).
TRAIN_GRAD_REL_TOL = 2.5e-2
TRAIN_LOSS_RTOL = 1e-3
# A qk_norm block's k_norm bias has an exact gradient of zero; measured on an
# H100 both sides' rounding noise is 1e-3 of k_norm's weight gradient or less.
ZERO_GRAD_REL = 1e-2
# accum_iter = 2 vs 1 on the same 64 images from the same weights: the same
# per-image arithmetic, but each microbatch's weight gradients are rounded to
# bf16 before they are summed in fp32 (2^-9 per element, independent), and
# cuBLAS may pick another tile order at half the rows (measured: 1e-5).
ACCUM_NORM_RTOL = 1e-3
TRAIN_BATCH = 64
TRAIN_STEPS = 8
REMAT_STEPS = 5
# cuBLAS's kernels among a traced step's (nvjet on this card), not the port's
GEMM_KERNEL = re.compile(r"nvjet|gemm|xmma|cutlass|cublas", re.IGNORECASE)
# the dynamic loss scale on train_bf16's gradients: its first scale, the
# finite steps after which it grows (the second step grows it), and the
# host timings' repeats
SCALER_INIT = 2.0 ** 16
SCALER_GROWTH = 2
SCALER_REPS = 20
# The drivers phase: the user's entry points (calibration through
# Tokenizer.from_checkpoint, cli.encode / evaluate / train) on the p16 model
# at full width and depth, on a webdataset shard of 256 JPEGs and an
# ImageFolder of 128 (2 classes), made by tae_tpu_torch.data.fake from a
# seed at 288 px (the val transform resizes the shorter side to 288 and
# crops 256)
DRIVER_MODEL = PATHS[0][0]
DRIVER_SHARD, DRIVER_VAL, DRIVER_PX = 256, 128, 288
DRIVER_BATCH = 64
DRIVER_WORKERS = 4
CALIB_BATCHES = 4
# The calibration pass, kernels (K1, K2 in fp32, exact softmax) vs
# backend="reference" on the same weights and images: fp32 on both sides,
# summation order and the last bits of exp / rsqrt only; per channel,
# relative to the channel's amax
CALIB_RTOL = 1e-4
# The evaluate driver's loss, kernels vs --attn_backend reference: bf16
# compute through 15 + 15 blocks (SLICE_REL_TOL of the reconstructions), the
# loss a mean of squares of the reconstruction error, relative. With random
# weights the loss is mostly the targets' own variance and moves little, so
# the reconstructions of the same images are held as well, at SLICE_REL_TOL
EVAL_REF_RTOL = 2e-2
# The evaluate driver's loss against the mean of the per-sample MSEs of the
# same weights and images computed outside the driver with the same
# kernels: the same products, fp32 means summed in another order, relative
EVAL_OWN_RTOL = 1e-5
# The train driver: iterations, eval / checkpoint every
DRIVER_TRAIN_ITS, DRIVER_SAVE_FREQ = 6, 3
# qknorm_blocks: (width, heads, depth, tokens) of each stack, timed steps
QKNORM_STACKS = ((1024, 16, 15, 256), (2560, 32, 2, 16))
QKNORM_STEPS = 3
# (batch, tokens, heads, head dim) of the attention backward's bf16 checks
# at the edges of its body's 16-row tiles and 128-row ranges (K10, K17;
# untimed, two runs bit-equal)
BWD_EDGES = tuple((2, n, 2, dh) for dh in (64, 80) for n in (1, 17, 129, 255))

# (batch, tokens, heads, head dim) of the attention backward's fp32 checks
# either side of its tiled body's rule (F32_BWD_TILED_MIN_TOKENS), at its
# key chunks' edges (32 keys at dh 64, 16 at dh 80) and at the most tokens,
# where every row tile is live (untimed, two runs bit-equal)
F32_BWD_EDGES = tuple((3, n, 2, dh) for dh in (64, 80)
                      for n in (16, 17, 33, 55, 56, 57, 255, 256))

# The downstream paths: the recognition and segmentation ViT-Base trunks
# (width 768, 12 heads of 64, 256 tokens) on the frozen p16 encoder.
# rec19k is the JAX bench's recipe for its train_rec19k_int8enc_mb64 cell
# (bench.py:259-300): the encoder in bf16, pruned to its encoder half, int8
# serving layout, run with the exact softmax as the drivers call it; the
# classifier with the in19k head, fp32 parameters, bf16 compute,
# adamw(weight_decay=0), step_lr(1e-4, 1e-5, 500_000), remat=True
REC_ENCODER = PATHS[0][0]
REC_MODEL = "vit_recognition_numpatches256_vocab256_base"
REC_CLASSES = 19167
REC_BATCH, REC_STEPS = 64, 8
# seg_p16: the segmenter on the frozen bf16 encoder at the driver's default
# batch, the driver's recipe (adamw(weight_decay=1e-4), lr 0.01, 21 classes)
SEG_MODEL = "vit_segmentation_numpatches256_vocab256_base"
SEG_CLASSES, SEG_BATCH, SEG_STEPS = 21, 8, 4
# The downstream drivers on fake data: an in19k shard of 128 JPEGs with
# classes in the 19167 of the head (DRIVER_WORKERS workers), in1k
# ImageFolders of 3 classes, 129 train images (two batches of 64) and 63
# val images (one short batch, padded), COCO instances of 32 and 16 images
# with learnable masks (make_structured_coco), all at DRIVER_PX. The in1k
# and segmentation runs, each compared with a run on the plain versions,
# load inline: worker processes hand their batches over in the order they
# finish, so two runs with workers can train on the same batches in other
# orders (in1k's eval losses 6.4% apart in one such pair of runs, equal to
# 8e-5 in another; NVIDIA H100 80GB HBM3, 700 W)
DS_SHARD, DS_CLASSES, DS_TRAIN_PER_CLASS, DS_VAL_PER_CLASS = 128, 3, 43, 21
DS_COCO_TRAIN, DS_COCO_VAL = 32, 16
DS_ITS, DS_SAVE_FREQ = 6, 3
# Driver losses, kernels vs --attn_backend reference, relative: bf16
# compute through the frozen encoder's 15 blocks and the trunk's 12 on the
# same weights and batches (the CPU tests' TRAIN_EVAL_RTOL against the JAX
# drivers)
DS_LOSS_RTOL = 2e-2
# The segmentation driver's runs take --lr 1e-4. At its default 0.01,
# AdamW throws the randomly initialised trunk about (seg_p16's losses over
# four steps on one batch: 4.76, 12.84, 9.81, 12.07), and such steps blow
# the bf16 rounding differences between the kernels and the plain versions
# up into other trajectories: one epoch's train losses 12.6% apart, where
# the first step's agree to 1e-6 (seg_p16, which holds a step at 0.01;
# NVIDIA H100 80GB HBM3, 700 W). At 1e-4 the runs follow one trajectory,
# and the comparison says whether the kernels compute what the plain
# versions do.
DS_SEG_LR = 1e-4
# The segmenter's argmax predictions on the val images, the first epoch's
# checkpoint run with the kernels and with the plain versions: classes whose
# logits lie within the bf16 rounding flips of each other may swap
DS_PRED_AGREE = 0.99

# train_p128_fsdp: the full p128 model through parallel.shard_model on
# this process's (1, 1, 1) mesh over NCCL, bf16 moments (K18); the world-2
# probe's gates (two ranks' bf16 weight gradients each over its own rows);
# the train driver as a torchrun launch of one against the same driver
# without a mesh (FSDP2 on one rank moves the same bits)
P128_FSDP_MODEL = PATHS[1][0]
P128_FSDP_BATCH, P128_FSDP_STEPS = 64, 3
WORLD2_TIMEOUT = 300
WORLD2_LOSS_RTOL, WORLD2_NORM_RTOL = 1e-5, 1e-3
DRIVER_MESH_RTOL = 1e-6
# drivers_mesh's depth: its point is the mesh plumbing (FSDP2 on a world of
# one against no mesh), which does not depend on depth; cut from 15 + 15 to
# keep the run inside its time with the step graphs' phase added
DRIVER_MESH_CUT = dict(depth=2, decoder_depth=2)
# train_graphs: each recipe's steps eager and from CUDA graphs (eager first
# step, capture on the second, replays after), the learning rate switching
# at GRAPH_SWITCH, from one seed each; the cache's model check timed over
# GRAPH_SNAPSHOT_REPS calls
GRAPH_STEPS, GRAPH_SWITCH, GRAPH_SNAPSHOT_REPS = 8, 4, 100
# the drivers' runs with --cuda_graphs off against the default, inline
# loading (one batch order for both): cli.train's and in19k's iterations,
# cli.train's eval every GRAPH_DRIVER_EVAL (one batch of 8 x 64 a pass: the
# second pass replays its graph), cli.evaluate's batch (four of them), and
# in1k's (eight steps, four eval batches)
GRAPH_DRIVER_ITS, GRAPH_DRIVER_EVAL = 3, 1
GRAPH_EVAL_BATCH = 32
# convergence: the convergence run's model at full width and depth (15 +
# 15, B = 64) on a small structured corpus made by data/fake (CONV_SHARDS
# shards of CONV_SHARD_IMAGES and a val ImageFolder of CONV_VAL, 288 px),
# trained through tae_tpu_torch.scripts.convergence in chunks of CONV_CHUNK
# iterations (each resumed with --resume_auto) to CONV_ITS at accum_iter 1,
# CONV_WORKERS loader workers (the card's machine decodes with PIL); then
# quant_accuracy's six modes on the checkpoint, on CONV_QUANT_BATCHES eval
# and CONV_CALIB_BATCHES calibration batches of CONV_QUANT_BATCH val images
CONV_MODEL = "tae_patch16_vocab16_px256"
CONV_SHARDS, CONV_SHARD_IMAGES, CONV_VAL, CONV_PX = 2, 320, 128, 288
CONV_ITS, CONV_CHUNK, CONV_BATCH, CONV_WORKERS = 300, 150, 64, 4
CONV_QUANT_BATCHES, CONV_CALIB_BATCHES, CONV_QUANT_BATCH = 2, 2, 32
# the eval MSE after CONV_ITS iterations against the seeded weights': at
# most this share of it (a run that learns nothing stays near 1)
CONV_EVAL_DROP = 0.5
# quant_accuracy's sanity bounds on the trained weights: each quantized
# mode's latent relative error against bf16 at most CONV_QUANT_REL_ERR and
# its reconstruction MSE at most CONV_QUANT_MSE_RATIO times bf16's (the
# JAX package's run of this recipe: 0.068-0.072 and 2.26-2.38 times, at
# 5000 iterations)
CONV_QUANT_REL_ERR, CONV_QUANT_MSE_RATIO = 0.2, 3.0
# the bf16 Tokenizer's serving path (encode / decode: the clamped softmax,
# from CUDA graphs) on the trained weights: its reconstruction MSE at most
# CONV_SERVING_MSE_RATIO times that of quant_accuracy's bf16 row on the same
# images (the JAX script's forward, the exact softmax: the metric of
# cli.evaluate)
CONV_SERVING_MSE_RATIO = 1.1
GRAPH_IN1K_BATCH = 16
# tensor2: two gloo ranks on the one card on a (1, 1, 2) mesh, every block
# split over tensor (8 heads a rank at p16, 16 at p128). The flagship at
# full width and depth takes one train_bf16-recipe step (bf16 moments) of a
# global batch of 16 (gloo carries each block's activation sums through the
# host: a larger batch only lengthens the run), p128 at full width and
# 2 + 2 blocks one step at B = 64, and a bf16 Tokenizer encodes a p16 batch
# of 8; each against this process's unsplit model on the same inputs, and
# each step also against the same step unsplit in the rank, leaf by leaf.
# The split rounds each rank's partial product of proj and fc2 to bf16
# before their fp32 sum, where one process rounds the whole product once;
# the latents are held to SLICE_REL_TOL (relative Frobenius error)
TENSOR2_MODEL = PATHS[0][0]
TENSOR2_BATCH, TENSOR2_P128_BATCH, TENSOR2_ENCODE_BATCH = 16, 64, 8
# tag -> (model, global batch, gradient clip, overrides): p128's step
# clips (its norm is near 0.053), so that the clipping of each rank's
# local shards is held too
TENSOR2_TRAIN = {"p16": (TENSOR2_MODEL, TENSOR2_BATCH, None, {}),
                 "p128": (P128_FSDP_MODEL, TENSOR2_P128_BATCH, 0.01,
                          dict(depth=2, decoder_depth=2))}
#: the leaves held after the step, in the first and last blocks: the split
#: layers and a LayerNorm whole on both ranks (its gradient is the peers')
TENSOR2_LEAVES = ("attn.qkv.weight", "mlp.fc1.weight", "attn.proj.weight",
                  "norm1.weight")
TENSOR2_TIMEOUT = 600
#: the linear layers' biases, zeros at init, are drawn instead: with zero
#: biases a bf16 peer sum of two bf16 partials equals the fp32 sum rounded
#: once (their fp32 sum is exact), and no control could tell them apart
TENSOR2_BIAS_STD = 0.02
#: tag -> relative limits of the split step against the same step unsplit
#: (loss, gradient norm, and the largest relative Frobenius error of the
#: leaves' updates and first moments). On an H100 (PERF.md § 6) the split
#: measured, p16 / p128: loss 2.3e-5 / 1.7e-6, norm 7.1e-5 / 5.6e-6,
#: updates 0.109 / 0.032 (a first AdamW step moves each element by about
#: the learning rate, signed by its gradient: near-zero gradients flip),
#: moments 0.0062 / 0.0119. The norm limit lies between the split and the
#: bf16_sum control (1.7e-4 / 1.2e-5); the loss and the leaves do not
#: tell the bf16 sum apart (loss 2.3e-6 / 2.7e-6, moments 0.0078 / 0.0120)
#: and gate what no_grad_sum shows (norm 0.37 / 0.12, moments 1.0 / 0.85,
#: updates 1.4 / 1.0)
TENSOR2_LIMITS = {
    "p16": dict(loss=1e-4, grad_norm=1.1e-4, moment=2.0 ** -6, update=0.25),
    "p128": dict(loss=1e-4, grad_norm=8.2e-6, moment=2.0 ** -6, update=0.25)}
#: control -> the limits it must miss: "bf16_sum" rounds the peer sum of
#: proj and fc2 to bf16 before the bias, "no_grad_sum" drops the peer sum
#: of the gradient entering qkv and fc1
TENSOR2_CONTROLS = {"bf16_sum": ("grad_norm",),
                    "no_grad_sum": ("grad_norm", "moment", "update")}

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W); fp32 is
# the CUDA cores' rate, which the float32 forms run at (no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

K1 = dict(name="fused_layer_norm", route="cuda",
          source="tae_tpu_torch/csrc/layernorm.cu",
          replaces="tae_tpu/ops/pallas/layernorm.py:24")
K2 = dict(name="fused_qkv_attention", route="cuda",
          source="tae_tpu_torch/csrc/flash_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:244")
K3 = dict(name="ln_quant", route="cuda",
          source="tae_tpu_torch/csrc/int8_block.cu",
          replaces="tae_tpu/ops/pallas/int8_block.py:48")
K4 = dict(name="int8_matmul_fused", route="cuda",
          source="tae_tpu_torch/csrc/int8_matmul.cu",
          replaces="tae_tpu/ops/pallas/int8_matmul.py:32")
K5 = dict(name="int8_mlp", route="cuda",
          source="tae_tpu_torch/csrc/int8_block.cu",
          replaces="tae_tpu/ops/pallas/int8_block.py:111")
K6 = dict(name="fused_qkv_attention_wide", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:307")
K7 = dict(name="fused_qkv_attention_q8", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:417")
K8 = dict(name="fused_qkv_attention_wide_q8", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:472")
K9 = dict(name="fused_qkv_attention_wide_q8_2d", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:543")
K10 = dict(name="fused_qkv_attention_bwd", route="cuda",
           source="tae_tpu_torch/csrc/flash_attention_bwd.cu",
           replaces="tae_tpu/ops/pallas/flash_attention.py:689")
K11 = dict(name="fused_layer_norm_bwd", route="cuda",
           source="tae_tpu_torch/csrc/layernorm.cu",
           replaces="tae_tpu/ops/pallas/layernorm.py:38")
K12 = dict(name="int4_matmul_fused", route="cuda",
           source="tae_tpu_torch/csrc/int4_matmul.cu",
           replaces="tae_tpu/ops/pallas/int4_matmul.py:40")
K13 = dict(name="int4_mlp", route="cuda",
           source="tae_tpu_torch/csrc/int4_block.cu",
           replaces="tae_tpu/ops/pallas/int4_block.py:56")
K14 = dict(name="nearest_code", route="cuda",
           source="tae_tpu_torch/csrc/quantizer.cu",
           replaces="tae_tpu/ops/pallas/quantizer.py:29")
K15 = dict(name="fused_qkv_attention_i8", route="cuda",
           source="tae_tpu_torch/csrc/flash_attention.cu",
           replaces="tae_tpu/ops/pallas/flash_attention.py:352")
K16 = dict(name="flash_attention", route="cuda",
           source="tae_tpu_torch/csrc/flash_attention.cu",
           replaces="tae_tpu/ops/pallas/flash_attention.py:37")
K17 = dict(name="flash_attention_bwd", route="cuda",
           source="tae_tpu_torch/csrc/flash_attention_bwd.cu",
           replaces="tae_tpu/ops/pallas/flash_attention.py:55")
# K18 replaces no TPU kernel: the JAX package's update is elementwise work
# that XLA fuses into the step (tae_tpu/train/optim.py:51-85); the line
# names that update
K18 = dict(name="adamw_update", route="cuda",
           source="tae_tpu_torch/csrc/adamw.cu",
           replaces="tae_tpu/train/optim.py:51",
           replaces_note="no pallas_call: adamw(moment_dtype=)'s update, "
                         "fused by XLA; torch.optim.AdamW keeps its moments "
                         "in the parameters' dtype")
KERNELS = (K1, K2, K3, K4, K5, K6, K7, K8, K9, K10, K11, K12, K13, K14, K15,
           K16, K17, K18)
# the training forwards are K1, K2 and K16 with one more output; they count
# their launches apart from the inference forwards
TRAIN_FORMS = {"fused_layer_norm": "fused_layer_norm_fwd_stats",
               "fused_qkv_attention": "fused_qkv_attention_fwd_lse",
               "flash_attention": "flash_attention_fwd_lse"}
# K4's int8_matmul_rows entry (the q8_out output mode and the in-kernel
# quantize of a float x) counts its launches apart too
ROW_FORMS = {"int8_matmul_fused": "int8_matmul_rows"}


# Kernels whose SASS phase_build reads: their ptxas report may show spills,
# so long as none lies in an innermost tensor-core loop, and both of their
# cluster barriers must stand on the main path
SASS_CHECKED = ("attention_q8_bf16",)
# The int8 GEMM body's products with the packed int4 weight (K12, K13) and
# their instantiations: no spills, ldmatrix in their SASS, no local memory
# in their innermost tensor-core loops
W4_PRODUCTS = {"int4_matmul_kernel": 4, "int4_mlp_fc1_kernel": 4,
               "int4_mlp_fc2_kernel": 4}
# The LayerNorm row kernels' register bodies (csrc/row_norm.cuh): K3 and K1
# at each nv of 1, 2, 4, 8, 10, 12, 16 and K11 at each of 1, 2, 4, 8, 10,
# all in the four pairs of x and affine dtypes. None may spill where a
# registered width runs it (1024, 2048, 2560 columns: nv 4, 8, 10).
ROW_NORM_BODIES = {"ln_quant_regs_kernel": 28, "layer_norm_fwd_rows_kernel": 28,
                   "layer_norm_bwd_rows_kernel": 20}
ROW_NORM_WIDTH_NV = (4, 8, 10)
# K14's bf16 search on TMA and wgmma (csrc/quantizer.cu), in its
# instantiations: one or two consumer warpgroups, z resident or riding the
# ring
VQ_SEARCH = "nearest_code_wgmma_kernel"
VQ_SEARCH_FORMS = 4
# The fp32 bodies on the CUDA cores and their instantiations: the
# register-tiled attention forward (dh 64 / 80, serving / exact) and its
# int8-output form behind K7 / K8 (dh 64 / 80, up to two heads a block or
# more), K14's fp32 search (z resident / riding the ring, 16 / 8 codes a
# thread), the register-tiled attention backward (dh 64 / 80, every row
# tile live or guarded) and the flat-row body's fp32 form (dh 64 / 80,
# exact / serving / int8). No spills.
F32_BODIES = {"attention_fwd_f32_tiled": 4, "attention_q8_f32_tiled": 4,
              "nearest_code_f32_kernel": 4, "attention_bwd_f32_tiled": 4,
              "rows_attention_f32": 6}
# The SASS of K4's and K5's finish passes, which run the first design of
# K3's row (int8_common.cuh::ln_quant_row), and of K1's forward, as the
# commit before the LayerNorm row kernels' redesign compiled them: sha256 of
# each kernel's instructions (bench/norm_body.py's sass_fingerprints),
# keyed by the nvcc release that compiled them. Under another release the
# build phase prints the fingerprints and compares none.
FINISH_SASS = {"V12.9.86": {"int8_matmul_finish_kernel": "feb0335991a37245",
                             "int8_mlp_finish_kernel": "0bc4fb7000f690c9",
                             "layer_norm_fwd_kernel": "a88b5e1d2c3e6db5"}}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card and never runs on the CPU")
    print(card_label())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")


def phase_build():
    from tae_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    lib = build.build_library()
    build.library()
    print(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(build.PACKAGE_DIR.parent)}")
    entry = ""
    body = {"attention_fwd_bf16": {}, "attention_q8_bf16": {},
            "rows_attention_bf16": {},
            "attention_bwd_bf16": {}, "int8_matmul_kernel": {},
            "int8_mlp_fc1_kernel": {}, "int8_mlp_fc2_kernel": {},
            **{kernel: {} for kernel in W4_PRODUCTS},
            **{kernel: {} for kernel in ROW_NORM_BODIES}, VQ_SEARCH: {},
            **{kernel: {} for kernel in F32_BODIES}}
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line or "registers" in line:
            print(f"[build] {entry}: {line.strip()}")
            for kernel in body:
                if kernel in entry:
                    body[kernel].setdefault(entry, []).append(line.strip())
    # the register-resident bodies: the attention forward (K2, K15, K16) at
    # dh 64 and 80, serving and exact, bf16 and (serving only) int8 sources,
    # and its int8-output form (K7, K8) at dh 64 and 80; the flat-row body
    # (K6 exact and serving, K9) at dh 64 and 80; the backward (K10,
    # K17) at dh 64 and 80; the int8 GEMM body's products (K4: three tile
    # shapes, each with its epilogue or its int32 partials; K5: fc1 at five
    # tile shapes, fc2 at three) and its packed int4 form (K12 and K13's fc1
    # and fc2 at two tile shapes each, each with a fold after whole ring
    # stages and one after every two k32 steps)
    for kernel, want in (("attention_fwd_bf16", 6), ("attention_q8_bf16", 2),
                         ("rows_attention_bf16", 6), ("attention_bwd_bf16", 2),
                         ("int8_matmul_kernel", 6), ("int8_mlp_fc1_kernel", 5),
                         ("int8_mlp_fc2_kernel", 3),
                         *W4_PRODUCTS.items()):
        found = body[kernel]
        check(len(found) == want, f"ptxas reported {len(found)} "
                                  f"instantiations of {kernel}, expected {want}")
        for entry, lines in found.items():
            spills = [int(x) for line in lines for x in
                      re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
            regs = [int(x) for line in lines for x in
                    re.findall(r"Used (\d+) registers", line)]
            m = re.search(kernel + r"ILi(\d+)E(?:Lb(\d))?", entry)
            rows_mode = re.search(r"rows_attention_bf16ILi\d+ELi(\d)E", entry)
            if rows_mode is not None:
                name = (f"{kernel} dh {m.group(1)} "
                        + ("exact", "serving", "int8")[int(rows_mode.group(1))])
            elif m is not None:
                form = "" if m.group(2) is None else (
                    f" {'serving' if m.group(2) == '1' else 'exact'} "
                    f"{'int8' if 'I8Src' in entry else 'bf16'}")
                name = f"{kernel} dh {m.group(1)}{form}"
            else:   # Tiles<BM, BN, WARPS_M, WARPS_N, STAGES, MINB>[, ...]
                tiles = re.search(r"TilesI((?:Li\d+E)+)E", entry)
                fold = re.search(r"RowsI4ILi(\d+)E", entry)
                name = (f"{kernel} <"
                        + ", ".join(re.findall(r"\d+", tiles.group(1)))
                        + ">" + (" partial" if "Lb1E" in entry else "")
                        + (f" int4, fold every {fold.group(1)} of K"
                           if fold else ""))
            print(f"[build] {name}: registers {regs}, spill bytes "
                  f"{sum(spills)}")
            check(len(spills) == 2 and (sum(spills) == 0
                                        or kernel in SASS_CHECKED),
                  f"ptxas spills in {entry}: {lines}")
    # K3's and K11's register bodies: registers and spills of each
    # instantiation, no spill at a registered width's nv
    for kernel, want in ROW_NORM_BODIES.items():
        found = body[kernel]
        check(len(found) == want, f"ptxas reported {len(found)} "
                                  f"instantiations of {kernel}, expected {want}")
        for entry, lines in sorted(found.items()):
            spills = sum(int(x) for line in lines for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            regs = [int(x) for line in lines for x in
                    re.findall(r"Used (\d+) registers", line)]
            m = re.search(kernel + r"I(13__nv_bfloat16|f)(\w+?)Li(\d+)E", entry)
            x_t = "bf16" if m.group(1) != "f" else "fp32"
            w_t = "fp32" if m.group(2).startswith("f") else "bf16"
            nv = int(m.group(3))
            print(f"[build] {kernel}<x {x_t}, affine {w_t}, nv {nv}>: "
                  f"registers {regs}, spill bytes {spills}")
            check(spills == 0 or nv not in ROW_NORM_WIDTH_NV,
                  f"ptxas spills in {entry} (nv {nv}, a registered width's): "
                  f"{lines}")
    # the finish passes that keep the first design's ln_quant_row, and K1's
    # forward, compiled as before the row kernels' redesign
    from tae_tpu_torch.bench.norm_body import sass_fingerprints

    release = nvcc_release()
    prints = sass_fingerprints(lib)
    want = FINISH_SASS.get(release)
    print(f"[build] SASS fingerprints (nvcc {release}): {prints}"
          + ("" if want else "; no recorded fingerprints for this release, "
             "none compared"))
    if want:
        check(prints == want, f"the SASS of {sorted(k for k in want if prints[k] != want[k])}"
                              f" changed: {prints}, recorded {want}")
    # K7 / K8's body unrolls its two heads and may keep a few values (a
    # block's head count, row maxima, addresses) across each head's sweep in
    # local memory: measured faster than a runtime head loop without spills,
    # whose registers cost the sweeps' schedule. Its innermost tensor-core
    # loops must touch no local memory. Its main path (the code ahead of the
    # first EXIT; nvcc puts the barriers' divergent fallbacks after it) must
    # hold both cluster barriers: the one that publishes the row maxima and
    # the one that keeps each block's shared memory alive until every block
    # has read it. Without the second the outputs stay right on every run
    # measured (the race is rare), so only the code can show it is there.
    for kernel in SASS_CHECKED:
        for entry, (loops, local, arrives, waits, _, _) in sass_report(lib, kernel).items():
            print(f"[build] {kernel}: {loops} innermost mma loops, {local} "
                  f"local-memory instructions in them; {arrives} cluster "
                  f"barrier arrives and {waits} waits on the main path "
                  f"({entry[:60]}...)")
            check(loops > 0 and local == 0,
                  f"{entry}: {local} local-memory instructions in its "
                  f"{loops} innermost mma loops")
            check(arrives == waits == 2, f"{entry}: {arrives} cluster "
                  f"barrier arrives and {waits} waits on the main path, "
                  "expected 2 and 2")
    # The flat-row body (K6, K9): no local memory in its innermost mma
    # loops; its int8 form (mode 2) holds both cluster barriers on its main
    # path, as K7 / K8's body does, the bf16 forms none.
    for entry, (loops, local, arrives, waits, _, _) in sass_report(
            lib, "rows_attention_bf16").items():
        mode = re.search(r"rows_attention_bf16ILi(\d+)ELi(\d)E", entry)
        want = 2 if mode.group(2) == "2" else 0
        print(f"[build] rows_attention_bf16 dh {mode.group(1)} mode "
              f"{mode.group(2)}: {loops} innermost mma loops, {local} "
              f"local-memory instructions in them; {arrives} cluster barrier "
              f"arrives and {waits} waits on the main path")
        check(loops > 0 and local == 0,
              f"{entry}: {local} local-memory instructions in its {loops} "
              "innermost mma loops")
        check(arrives == waits == want, f"{entry}: {arrives} cluster barrier "
              f"arrives and {waits} waits on the main path, expected {want}")
    # The int4 products: B read by ldmatrix (the packed words of four k32
    # steps a load) and decoded in registers, nothing of the mainloop in
    # local memory.
    for kernel in W4_PRODUCTS:
        for entry, (loops, local, _, _, ldsm, _) in sass_report(lib, kernel).items():
            print(f"[build] {kernel}: {loops} innermost mma loops, {local} "
                  f"local-memory instructions in them, {ldsm} ldmatrix "
                  f"({entry[:60]}...)")
            check(loops > 0 and local == 0 and ldsm > 0,
                  f"{entry}: {loops} innermost mma loops with {local} "
                  f"local-memory instructions, {ldsm} ldmatrix")
    # K14's bf16 search: wgmma (HGMMA in its SASS), no spill, no local
    # memory in its innermost product loops, and no wgmma serialized by
    # ptxas (it says so where a wait or an accumulator read sits on a path
    # it takes for divergent)
    for entry, lines in sorted(body[VQ_SEARCH].items()):
        spills = sum(int(x) for line in lines for x in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", line))
        regs = [int(x) for line in lines for x in
                re.findall(r"Used (\d+) registers", line)]
        print(f"[build] {VQ_SEARCH} {entry[-60:]}: registers {regs}, spill "
              f"bytes {spills}")
        check(spills == 0, f"ptxas spills in {entry}: {lines}")
    check(len(body[VQ_SEARCH]) == VQ_SEARCH_FORMS,
          f"ptxas reported {len(body[VQ_SEARCH])} instantiations of "
          f"{VQ_SEARCH}, expected {VQ_SEARCH_FORMS}")
    serial = [line for line in (lib.parent / "build.log").read_text().splitlines()
              if "wgmma.mma_async instructions are serialized" in line]
    check(not serial, f"ptxas serialized wgmma: {serial[:2]}")
    for entry, (loops, local, _, _, _, hgmma) in sass_report(lib, VQ_SEARCH).items():
        print(f"[build] {VQ_SEARCH}: {hgmma} HGMMA, {loops} innermost product "
              f"loops, {local} local-memory instructions in them "
              f"({entry[:70]}...)")
        check(hgmma > 0 and loops > 0 and local == 0,
              f"{entry}: {hgmma} HGMMA, {loops} innermost product loops with "
              f"{local} local-memory instructions")
    # the fp32 CUDA-core bodies (K2 / K16 forward and its int8 form behind
    # K7 / K8, K14's search, K10 / K17's backward, the flat-row body behind
    # K6 / K9): no spill in any instantiation
    for kernel, want in F32_BODIES.items():
        found = body[kernel]
        check(len(found) == want, f"ptxas reported {len(found)} "
                                  f"instantiations of {kernel}, expected {want}")
        for entry, lines in sorted(found.items()):
            spills = sum(int(x) for line in lines for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            regs = [int(x) for line in lines for x in
                    re.findall(r"Used (\d+) registers", line)]
            args = re.search(kernel + r"I((?:L[ib]\d+E)+)E", entry)
            print(f"[build] {kernel}<{args.group(1) if args else entry}>: "
                  f"registers {regs}, spill bytes {spills}")
            check(spills == 0, f"ptxas spills in {entry}: {lines}")


@functools.lru_cache(maxsize=None)
def sass_functions(lib) -> tuple:
    """(name, SASS) of every function in the library ``lib``, from one
    ``cuobjdump -sass`` (each check reads it; the library is built once)."""
    from tae_tpu_torch.ops.cuda import build

    cuobjdump = pathlib.Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    return tuple(tuple(fn.split("\n", 1))
                 for fn in re.split(r"\n\s*Function : ", sass)[1:])


def sass_report(lib, kernel: str) -> dict:
    """Per instantiation of ``kernel`` in the library, read from
    ``cuobjdump -sass``: (the innermost loops that issue tensor-core
    products (HMMA, IMMA, HGMMA), the local-memory instructions LDL / STL in
    them, the cluster barrier arrives and waits ahead of the first EXIT, the
    ldmatrix instructions, the warpgroup products HGMMA). A loop is the span
    from a backward branch's target to the branch."""
    import bisect

    found = {}
    for name, body in sass_functions(lib):
        if kernel not in name:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);",
            body)]
        addr = [a for a, _, _ in ins]
        ops = [op for _, op, _ in ins]
        mma = []
        for i, (a, op, rest) in enumerate(ins):
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target and int(target.group(1), 16) < a:
                j = bisect.bisect_left(addr, int(target.group(1), 16))
                if any(o.startswith(("HMMA", "IMMA", "HGMMA")) for o in ops[j:i + 1]):
                    mma.append((j, i))
        inner = [(j, i) for j, i in mma
                 if not any(j <= j2 and i2 <= i and (j2, i2) != (j, i)
                            for j2, i2 in mma)]
        local = sum(o.startswith(("LDL", "STL"))
                    for j, i in inner for o in ops[j:i + 1])
        main = ops[:ops.index("EXIT")] if "EXIT" in ops else ops
        found[name] = (len(inner), local, main.count("UCGABAR_ARV"),
                       main.count("UCGABAR_WAIT"),
                       sum(o.startswith("LDSM") for o in ops),
                       sum(o.startswith("HGMMA") for o in ops))
    return found


def nvcc_release() -> str:
    """nvcc's release, as its --version prints it (for example V12.4.131)."""
    from tae_tpu_torch.ops.cuda import build

    out = subprocess.run([build.find_nvcc(), "--version"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return re.search(r"release [\d.]+, (V[\d.]+)", out).group(1)


def time_ms(fn) -> float:
    """Device time of one call of ``fn`` in ms: TIMED_REPS calls are captured
    in a CUDA graph after a warm-up, the graph is replayed GRAPH_REPLAYS
    times between CUDA events, and the median replay is divided by the
    calls. A replay has no host work between the launches, so a kernel of a
    few microseconds is not measured as its wrapper's Python time (a single
    launch between two events reads 0.03-0.05 ms for any small kernel)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_REPS):
            fn()
    graph.replay()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMED_REPS)
    return statistics.median(times)


def time_ms_events(fn) -> float:
    """Device time of one call of ``fn`` in ms between CUDA events around
    TIMED_REPS calls, median of GRAPH_REPLAYS rounds, no graph: for a
    library's backward through ``torch.autograd.grad``, whose engine runs
    its nodes on a thread of its own, outside a stream capture. Good for
    calls whose device time exceeds their host time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMED_REPS)
    return statistics.median(times)


def compare(label: str, got, want, atol: float, rtol: float) -> float:
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = float(err.max())
    check(bool((err <= bound).all()),
          f"{label}: max |kernel - plain| {worst:.3g} exceeds atol {atol} "
          f"+ rtol {rtol}")
    return worst


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: int, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what binds): each input read once and
    each output written once at the memory rate, against the operations at
    the tensor cores' peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_kind(dtype) -> str:
    """The peak rate a float dtype's products run at: fp32 on the CUDA
    cores (no TF32), bf16 on the tensor cores."""
    return "fp32" if str(dtype) == "torch.float32" else "bf16"


def compare_codes(label: str, got, want) -> float:
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype == torch.int8,
          f"{label}: {tuple(got.shape)} {got.dtype}")
    diff = (got.int() - want.int()).abs()
    share = float((diff > 0).float().mean())
    check(int(diff.max()) <= 1 and share <= CODE_FLIP_SHARE,
          f"{label}: codes differ by up to {int(diff.max())} on a share "
          f"{share:.3g} of elements (allowed: 1 on {CODE_FLIP_SHARE})")
    return share


def compare_scales(label: str, got, want, rtol: float = SCALE_RTOL,
                   loose_share: float = 0.0, loose_rtol: float = 0.0) -> float:
    """Scales agree to ``rtol``; with ``loose_share``, that share of them may
    differ by up to ``loose_rtol`` instead. Returns the worst relative
    difference."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype == torch.float32,
          f"{label}: {tuple(got.shape)} {got.dtype}")
    rel = (got - want).abs() / want.abs()
    worst, beyond = float(rel.max()), float((rel > rtol).float().mean())
    check(beyond <= loose_share and worst <= max(rtol, loose_rtol),
          f"{label}: scales differ by up to {worst:.3g} relative, a share "
          f"{beyond:.3g} of them beyond {rtol} (allowed: {loose_share} up to "
          f"{loose_rtol})")
    return worst


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.flash_attention import (
        fused_qkv_attention, fused_qkv_attention_reference)
    from tae_tpu_torch.ops.cuda.layernorm import (fused_layer_norm, fwd_plan,
                                                  fwd_plan_of_library)
    from tae_tpu_torch.ops.layernorm import layer_norm_reference

    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {"fused_layer_norm": [], "fused_qkv_attention": []}

    def randn(shape, dtype, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale + shift).to(dtype)

    # K1 at the bf16 path's shape in both dtypes, then at p128's width,
    # (M, 2560) bf16 at M = 256 / 32 / 4 (B = 64 / 8 / 1), its launch plan
    # held against the library's at each
    for rows, d, dtype in ((KERNEL_BATCH * 256, 1024, torch.bfloat16),
                           (KERNEL_BATCH * 256, 1024, torch.float32),
                           (256, 2560, torch.bfloat16),
                           (32, 2560, torch.bfloat16),
                           (4, 2560, torch.bfloat16)):
        tol = TOL[str(dtype).split(".")[1]]
        check(fwd_plan_of_library(rows, d) == fwd_plan(rows, d),
              f"K1's plan at ({rows}, {d}): library {fwd_plan_of_library(rows, d)}, "
              f"ops/cuda/layernorm.fwd_plan {fwd_plan(rows, d)}")
        x = randn((rows, d), dtype, 3.0, 1.0)
        w, b = randn((d,), dtype, 1.0, 1.0), randn((d,), dtype)
        got = fused_layer_norm(x, w, b, 1e-6)
        want = layer_norm_reference(x, w, b, 1e-6)
        err = compare(f"K1 {tuple(x.shape)} {dtype}", got, want, **tol)
        ms = time_ms(lambda: fused_layer_norm(x, w, b, 1e-6))
        plain = time_ms(lambda: layer_norm_reference(x, w, b, 1e-6))
        lib = time_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-6))
        bnd = bound(nbytes(x, w, b, got), 0.0, "bf16")
        res["fused_layer_norm"].append((dtype, err, ms, plain, bnd, lib))
        print(f"[kernels] K1 layer_norm {tuple(x.shape)} {dtype} (plan "
              f"{fwd_plan(rows, d)}): max_abs_err "
              f"{err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}); kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), F.layer_norm {lib:.4f} ms")

    # the slice's shape, p32's, a dh=80 shape (p64 configs), and N=4 (p128),
    # which pads the token axis to the kernel's 16-row tiles, in both
    # dtypes; a tensor rank's share of the split Tokenizer's encode
    # (tensor2: 8 heads of the p16 shape at its batch) in bf16
    both, bf16_only = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    for b, n, h, dh, dtypes in ((KERNEL_BATCH, 256, 16, 64, both),
                                (KERNEL_BATCH, 64, 32, 64, both),
                                (KERNEL_BATCH, 16, 32, 80, both),
                                (KERNEL_BATCH, 4, 32, 80, both),
                                (TENSOR2_ENCODE_BATCH, 256, 8, 64, bf16_only)):
        c = h * dh
        for dtype in dtypes:
            tol = TOL[str(dtype).split(".")[1]]
            qkv = randn((b, n, 3 * c), dtype)
            for serving in (True, False):
                got = fused_qkv_attention(qkv, h, serving=serving)
                want = fused_qkv_attention_reference(qkv, h, serving=serving)
                mode = "serving" if serving else "exact"
                err = compare(f"K2 {tuple(qkv.shape)} h{h} {dtype} {mode}",
                              got, want, **tol)
                ms = time_ms(lambda: fused_qkv_attention(qkv, h,
                                                         serving=serving))
                plain = time_ms(lambda: fused_qkv_attention_reference(
                    qkv, h, serving=serving))
                bnd = bound(nbytes(qkv, got), 4.0 * b * h * n * n * dh,
                            "bf16" if dtype == torch.bfloat16 else "fp32")
                lib = None
                if not serving:
                    # the library call has only the exact softmax
                    r = qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
                    lib = time_ms(lambda: F.scaled_dot_product_attention(
                        r[0], r[1], r[2]))
                res["fused_qkv_attention"].append(
                    (dtype, err, ms, plain, n, serving, bnd, lib))
                lib_s = "" if lib is None else f", SDPA {lib:.4f} ms"
                print(f"[kernels] K2 attention {tuple(qkv.shape)} h={h} "
                      f"dh={dh} {dtype} {mode}: max_abs_err {err:.3g} "
                      f"(atol {tol['atol']}, rtol {tol['rtol']}); kernel "
                      f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
                      f"{bnd[0]:.4f} ms ({bnd[1]}){lib_s}")

    # the fp32 bodies (the first design below F32_TILED_MIN_TOKENS tokens,
    # the register-tiled one from there) where their 64-key chunks and
    # 64-row blocks end: K2's three forms packed, K16's two with v a view of
    # the packed projection, at dh 64 and 80
    from tae_tpu_torch.ops.cuda.flash_attention import (
        F32_TILED_MIN_TOKENS, flash_attention, flash_attention_fwd_lse,
        flash_attention_reference, fused_qkv_attention_fwd_lse,
        fused_qkv_attention_lse_reference)

    f32, tol = torch.float32, TOL["float32"]
    edges = (1, 4, 16, F32_TILED_MIN_TOKENS - 1, F32_TILED_MIN_TOKENS, 63, 64,
             65, 129, 255, 256)
    for dh in (64, 80):
        for n in edges:
            h = 2 if dh == 64 else 3
            qkv = randn((3, n, 3 * h * dh), f32)
            shape = f"(3, {n}, {3 * h * dh}) h={h} dh={dh} fp32"
            for serving in (True, False):
                compare(f"K2 {shape} {'serving' if serving else 'exact'}",
                        fused_qkv_attention(qkv, h, serving=serving),
                        fused_qkv_attention_reference(qkv, h, serving=serving), **tol)
            o, lse = fused_qkv_attention_fwd_lse(qkv, h)
            o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
            compare(f"K2 with LSE {shape}", o, o_ref, **tol)
            compare(f"K2 with LSE {shape} lse", lse, lse_ref, **STATS_TOL)
            r = qkv.view(3, n, 3, h, dh).permute(2, 0, 3, 1, 4)
            q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
            o_ref, lse_ref = flash_attention_reference(q, k, v)
            compare(f"K16 {shape}", flash_attention(q, k, v), o_ref, **tol)
            o, lse = flash_attention_fwd_lse(q, k, v)
            compare(f"K16 with LSE {shape}", o, o_ref, **tol)
            compare(f"K16 with LSE {shape} lse", lse, lse_ref, **STATS_TOL)
    print(f"[kernels] K2 (serving, exact, LSE) and K16 (exact, LSE) fp32 at n = "
          f"{edges}, dh 64 and 80: within atol {tol['atol']}, rtol {tol['rtol']} "
          f"(tiled body from {F32_TILED_MIN_TOKENS} tokens)")
    # the tiled body's ring: each K and V chunk is waited for before it is
    # read; a read ahead of its cp.async shows as runs that differ. Eight
    # runs at the main path's shape in both forms, each bit-equal to the
    # first, on fresh inputs each time
    for serving in (True, False):
        for i in range(8):
            qkv = randn((KERNEL_BATCH, 256, 3 * 1024), f32)
            got = fused_qkv_attention(qkv, 16, serving=serving)
            again = fused_qkv_attention(qkv, 16, serving=serving)
            check(torch.equal(got, again), f"K2 fp32 serving={serving}: two runs "
                                           "on the same input differ")
            if i == 0:
                compare(f"K2 fp32 rerun serving={serving}", got,
                        fused_qkv_attention_reference(qkv, 16, serving=serving), **tol)
    print("[kernels] K2 fp32 (64, 256, 3072) h16: 8 inputs x 2 runs bit-equal, "
          "both forms")

    # the exact form on scores in the hundreds, far past the serving clip,
    # across three 64-key chunks: exp(s) alone overflows fp32, so only the
    # row max of every chunk keeps the output finite and right
    n, h, dh = 129, 4, 64
    qkv = randn((8, n, 3 * h * dh), torch.float32)
    qkv[:, :, :h * dh] *= 60.0
    qkv = qkv.to(torch.bfloat16)
    want = fused_qkv_attention_reference(qkv, h, serving=False)
    check(bool(torch.isfinite(want).all()), "K2 far past the clip: plain "
                                           "version not finite")
    label = (f"K2 attention {tuple(qkv.shape)} h={h} dh={dh} exact, q x 60 "
             "(scores far past the serving clip)")
    err = compare(label, fused_qkv_attention(qkv, h, serving=False), want,
                  **TOL["bfloat16"])
    print(f"[kernels] {label}: max_abs_err {err:.3g}")
    return res


def phase_int8_kernels() -> dict:
    """K3, K4 and K5 against their plain versions at the int8 slice's shapes
    (B = 64: M = 16384 rows) and at one odd row count each. Returns one
    list of case records per kernel; the first is the main-path shape."""
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.bench.rows_body import empty_library
    from tae_tpu_torch.ops.cuda import build
    from tae_tpu_torch.ops.cuda.int8_block import (
        int8_mlp, int8_mlp_reference, ln_quant, ln_quant_plan,
        ln_quant_plan_of_library, ln_quant_reference)
    from tae_tpu_torch.ops.cuda.int8_matmul import (
        int8_matmul_fused, int8_matmul_reference)
    from tae_tpu_torch.ops.int8 import DEFAULT_BLOCK_H, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    m_full, d, hdim = KERNEL_BATCH * 256, 1024, 4096
    res = {"ln_quant": [], "int8_matmul_fused": [], "int8_mlp": []}

    def randn(shape, scale=1.0, shift=0.0, dtype=bf16):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale + shift).to(dtype)

    def rand_i8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    def record(kernel, label, err, ms, plain, bnd, lib=None, extra=""):
        res[kernel].append(dict(case=label, max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=bnd[0],
                                bound_by=bnd[1], library_ms=lib))
        timing = "" if ms is None else (
            f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        print(f"[kernels] {label}: max_abs_err {err:.3g}{timing}{extra}")

    # ---- K3: p16's shape, an odd row count, and p128's width at the rows
    #      of B = 64, 8 and 1 (the int4 path's 44 launches a request), each
    #      with its launch plan held against the library's; at p128's an
    #      empty kernel on K3's grid beside it (the bound there is under a
    #      launch)
    g, be = randn((d,), 0.5, 1.0), randn((d,), 0.2)   # also K5's ln_next
    empty = empty_library()
    for m, w in ((m_full, d), (1001, d), (256, 2560), (32, 2560), (4, 2560)):
        gw, bw = (g, be) if w == d else (randn((w,), 0.5, 1.0), randn((w,), 0.2))
        x = randn((m, w), 3.0, 1.0)
        plan = ln_quant_plan(m, w)
        check(ln_quant_plan_of_library(m, w) == plan,
              f"K3's plan at ({m}, {w}): library {ln_quant_plan_of_library(m, w)}, "
              f"ops/cuda/int8_block.ln_quant_plan {plan}")
        q, s = ln_quant(x, gw, bw, 1e-6)
        q_ref, s_ref = ln_quant_reference(x, gw, bw, 1e-6)
        label = f"K3 ln_quant ({m}, {w}) bf16"
        compare_scales(label, s, s_ref)
        share = compare_codes(label, q, q_ref)
        err = float((q.float() * s - q_ref.float() * s_ref).abs().max())
        timed = m != 1001
        extra = (f"; codes off by one on a share {share:.2g}; plan nv {plan.nv}, "
                 f"{plan.blocks} blocks of {plan.warps} warps")
        if w == 2560:
            empty_ms = time_ms(lambda: build.check(empty.tae_empty_launch(
                plan.blocks, 1, 32 * plan.warps, 1,
                torch.cuda.current_stream().cuda_stream), "empty launch"))
            extra += f"; empty kernel on its grid {empty_ms:.4f} ms"
        record("ln_quant", label, err,
               time_ms(lambda: ln_quant(x, gw, bw, 1e-6)) if timed else None,
               time_ms(lambda: ln_quant_reference(x, gw, bw, 1e-6))
               if timed else None,
               bound(nbytes(x, gw, bw, q, s), 0.0, "int8"), extra=extra)
        if w == 2560:
            res["ln_quant"][-1]["empty_launch_ms"] = empty_ms

    # ---- K4: the five products of the main path, then the epilogue forms
    #      on the proj shape, then an odd row count
    def k4_case(name, m, k, n, bias, residual, ln, timed=True, lib=False,
                repeats=0):
        xq, sx = rand_i8((m, k)), scales((m, 1), 0.01, 0.06)
        wq, sw = rand_i8((n, k)), scales((n,), 1e-4, 5e-4)
        b = randn((n,)) if bias else None
        r = randn((m, n)) if residual else None
        ln_out = (randn((n,), 0.5, 1.0), randn((n,), 0.2), 1e-6) if ln else None
        got = int8_matmul_fused(xq, sx, wq, sw, b, r, bf16, ln_out)
        want = int8_matmul_reference(xq, sx, wq, sw, b, r, bf16, ln_out)
        label = (f"K4 int8_matmul {name} ({m}, {k}) x ({n}, {k})"
                 f"{' +bias' if bias else ''}{' +residual' if residual else ''}"
                 f"{' +ln_out' if ln else ''}")
        extra, outs = "", [got]
        if ln:
            compare_scales(label, got[2], want[2])
            share = compare_codes(label, got[1], want[1])
            extra = f"; ln_out codes off by one on a share {share:.2g}"
            outs, got, want = list(got), got[0], want[0]
        err = compare(label, got, want, **tol)
        if repeats:
            # ROADMAP C6: the same call again, each output bit for bit
            differ = [i + 1 for i in range(repeats) if not torch.equal(
                int8_matmul_fused(xq, sx, wq, sw, b, r, bf16, ln_out), got)]
            check(not differ, f"{label}: repeats {differ} of {repeats} differ "
                              "from the first call")
            extra += f"; {repeats} repeats bit-equal to the first call"
        lib_ms = None
        if lib and m > 16:   # torch._int_mm takes more than 16 rows
            lib_ms = time_ms(lambda: torch._int_mm(xq, wq.t()))
            extra += f"; torch._int_mm (product only) {lib_ms:.4f} ms"
        record("int8_matmul_fused", label, err,
               time_ms(lambda: int8_matmul_fused(xq, sx, wq, sw, b, r, bf16,
                                                 ln_out)) if timed else None,
               time_ms(lambda: int8_matmul_reference(xq, sx, wq, sw, b, r,
                                                     bf16, ln_out))
               if timed else None,
               bound(nbytes(xq, sx, wq, sw, b, r, *outs)
                     + (nbytes(*ln_out[:2]) if ln else 0),
                     2.0 * m * k * n, "int8"), lib_ms, extra)

    k4_case("qkv", m_full, d, 3 * d, True, False, False, lib=True,
            repeats=K4_REPEATS)
    k4_case("proj", m_full, d, d, True, True, True, lib=True)
    k4_case("dict_proj", m_full, d, 256, False, False, False, lib=True)
    k4_case("embed", m_full, 256, d, True, False, False, lib=True)
    k4_case("pred", m_full, d, 768, True, False, False, lib=True)
    k4_case("proj", m_full, d, d, True, False, False)
    k4_case("proj", m_full, d, d, True, True, False)
    k4_case("odd M", 1001, d, d, True, True, True, timed=False)
    k4_case("odd M", 1001, d, 3 * d, True, False, False, timed=False)
    # the p128 and p32 products (every tile shape and K split of the GEMM
    # body: 16-row tiles split four ways at M = 4, 64-row tiles at 256)
    for m in (256, 32, 4):
        k4_case("p128 qkv", m, 2560, 7680, True, False, False, lib=True)
        k4_case("p128 proj", m, 2560, 2560, True, True, True, lib=True)
    k4_case("p32 qkv", 4096, 2048, 6144, True, False, False, lib=True)
    k4_case("p32 proj", 4096, 2048, 2048, True, True, True, lib=True)
    # ragged edges of the tiles: one row, a 16-row tile and one, a 128-row
    # tile and one; N 8 past a tile; K 16 past a 128-byte ring step
    for m, n in ((1, 136), (17, 1032), (129, 264)):
        k4_case("tile edge", m, 1040, n, True, True, True, timed=False)
        k4_case("tile edge", m, 1040, n, False, False, False, timed=False)

    # ---- K5
    w1, s1 = rand_i8((hdim, d)), scales((hdim,), 1e-4, 5e-4)
    w2, s2 = rand_i8((d, hdim)), scales((d,), 1e-4, 5e-4)
    b1, b2 = randn((hdim,), 0.1), randn((d,), 0.1)
    ln_next = (g, be, 1e-6)
    bh = DEFAULT_BLOCK_H
    wide = {}
    for dd, hh in ((2560, 10240), (2048, 8192), (1040, 768)):
        gg, bb = randn((dd,), 0.5, 1.0), randn((dd,), 0.2)
        wide[dd] = (rand_i8((hh, dd)), scales((hh,), 1e-4, 5e-4),
                    rand_i8((dd, hh)), scales((dd,), 1e-4, 5e-4),
                    randn((hh,), 0.1), randn((dd,), 0.1), (gg, bb, 1e-6))
    # the p16 shape, then p128's (256, 32 and 4 rows: fc1 and fc2 tiles of
    # 64 and 16 rows, two hidden groups at 4 rows) and p32's, then ragged
    # rows and D 16 past a tile with three hidden blocks (untimed)
    mlp_cases = [(m_full, d, ln_next, True), (m_full, d, None, True),
                 (1001, d, ln_next, False), (256, 2560, True, True),
                 (32, 2560, True, True), (4, 2560, True, True),
                 (4096, 2048, True, True), (1, 1040, True, False),
                 (17, 1040, True, False), (129, 1040, True, False)]
    for m, dm, ln, timed in mlp_cases:
        if dm == d:
            mw = (w1, s1, b1, w2, s2, b2)
            hd = hdim
        else:
            ww1, ss1, ww2, ss2, bb1, bb2, ln = wide[dm]
            mw, hd = (ww1, ss1, bb1, ww2, ss2, bb2), ww1.shape[0]
        xq, sx = rand_i8((m, dm)), scales((m, 1), 0.005, 0.025)
        r = randn((m, dm))
        args = (xq, sx, *mw[:3], *mw[3:], r, bh, bf16, ln)
        got, want = int8_mlp(*args), int8_mlp_reference(*args)
        label = (f"K5 int8_mlp ({m}, {dm}) hidden {hd} block_h {bh}"
                 f"{' +ln_next' if ln else ''}")
        extra, outs = "", [got]
        if ln:
            compare_scales(label, got[2], want[2], MLP_SCALE_RTOL)
            share = compare_codes(label, got[1], want[1])
            extra = f"; ln_next codes off by one on a share {share:.2g}"
            outs, got, want = list(got), got[0], want[0]
        err = compare(label, got, want, **tol)
        record("int8_mlp", label, err,
               time_ms(lambda: int8_mlp(*args)) if timed else None,
               time_ms(lambda: int8_mlp_reference(*args)) if timed else None,
               bound(nbytes(xq, sx, *mw, r, *outs)
                     + (nbytes(*ln[:2]) if ln else 0),
                     4.0 * m * dm * hd, "int8"), None, extra)

    # the same MLP unfused, as a yardstick for K5: K4, GELU and a whole-row
    # quantize in plain PyTorch, K4 with the residual (other numerics: one
    # hidden scale per row)
    xq, sx = rand_i8((m_full, d)), scales((m_full, 1), 0.005, 0.025)
    r = randn((m_full, d))

    def unfused():
        h = int8_matmul_fused(xq, sx, w1, s1, b1, None, bf16)
        hq, sh = quantize_rows(F.gelu(h, approximate="tanh"))
        return int8_matmul_fused(hq, sh, w2, s2, b2, r, bf16)

    ms = time_ms(unfused)
    res["int8_mlp"][0]["unfused_ms"] = ms
    print(f"[kernels] K5 yardstick: the MLP unfused (K4, plain GELU and "
          f"quantize, K4) at ({m_full}, {d}) hidden {hdim}: {ms:.4f} ms")
    return res


def phase_attention_kernels() -> dict:
    """K6-K9 against their plain versions at the shapes of the tiny-N and
    int8 paths (B = 64; K6 and K9 at p128's shape also at B = 8 and 1) and
    at an odd batch each, and beside the per-image kernel K2 (plus the plain
    per-row quantize for the int8-output entries) at the same shape; each
    body's launch plan against the library's. Returns one list of case
    records per kernel; the first is the shape of that kernel's full-depth
    path."""
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.flash_attention import fused_qkv_attention
    from tae_tpu_torch.ops.cuda.wide_attention import (
        fused_qkv_attention_q8, fused_qkv_attention_q8_reference,
        fused_qkv_attention_wide, fused_qkv_attention_wide_q8,
        fused_qkv_attention_wide_q8_2d,
        fused_qkv_attention_wide_q8_2d_reference,
        fused_qkv_attention_wide_q8_reference,
        fused_qkv_attention_wide_reference, q8_plan, q8_plan_of_library,
        rows_plan, rows_plan_of_library)
    from tae_tpu_torch.ops.int8 import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(2468)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    res = {k["name"]: [] for k in (K6, K7, K8, K9)}
    odd = 7

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def record(kernel, label, err, timing, extra=""):
        res[kernel].append(dict(case=label, max_abs_err=err, **timing))
        line = ""
        if timing["ms"] is not None:
            line = (f"; kernel {timing['ms']:.4f} ms, plain "
                    f"{timing['plain_ms']:.4f} ms, bound "
                    f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
        print(f"[kernels] {label}: max_abs_err {err:.3g}{line}{extra}")

    def timing(fn, plain, qkv, outs, h, n, dh, timed, kind="bf16"):
        b = qkv.numel() // (n * 3 * h * dh)
        bnd = bound(nbytes(qkv, *outs), 4.0 * b * h * n * n * dh, kind)
        return dict(ms=time_ms(fn) if timed else None,
                    plain_ms=time_ms(plain) if timed else None,
                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)

    def rows_plan_line(label, n, h, dh, q8) -> str:
        """The flat-row body's plan in the library against rows_plan."""
        plan, units = rows_plan_of_library(n, h, dh, q8)
        check(plan is not None and plan == rows_plan(n, h, dh, q8),
              f"{label}: the library plans {plan}, "
              f"ops/cuda/wide_attention.rows_plan {rows_plan(n, h, dh, q8)}")
        check(units > 0, f"{label}: no {'cluster' if q8 else 'block'} of "
              f"{plan} fits on the card")
        return (f"; flat-row body, {plan.groups} groups of "
                f"{plan.heads_per_block} heads"
                + (f" in a cluster, {units} clusters at once" if q8
                   else f", {units} blocks at once"))

    def compare_q8(label, got, want) -> tuple[float, float]:
        (q, s), (q_ref, s_ref) = got, want
        compare_scales(label, s, s_ref, SCALE_RTOL, ATTN_SCALE_SHARE,
                       ATTN_SCALE_RTOL)
        share = compare_codes(label, q, q_ref)
        return float((q.float() * s - q_ref.float() * s_ref).abs().max()), share

    # ---- K6, bf16 output: p128 (at B = 64, 8 and 1), p64 and p32 shapes,
    #      8 tokens (the last count at which images share a tile), and a
    #      tensor rank's 16 heads of p128 (tensor2); both softmax forms
    for n, h, dh in ((4, 32, 80), (8, 32, 80), (16, 32, 80), (64, 32, 64),
                     (4, 16, 80)):
        for b in ((KERNEL_BATCH, 8, 1, odd) if (n, h) == (4, 32)
                  else (KERNEL_BATCH, odd)):
            qkv = randn((b, n, 3 * h * dh))
            for serving in (True, False):
                got = fused_qkv_attention_wide(qkv, h, serving=serving)
                want = fused_qkv_attention_wide_reference(qkv, h,
                                                          serving=serving)
                mode = "serving" if serving else "exact"
                label = f"K6 wide {tuple(qkv.shape)} h={h} dh={dh} bf16 {mode}"
                err = compare(label, got, want, **tol)
                timed = b == KERNEL_BATCH or ((n, h) == (4, 32) and b != odd)
                t = timing(lambda: fused_qkv_attention_wide(qkv, h,
                                                            serving=serving),
                           lambda: fused_qkv_attention_wide_reference(
                               qkv, h, serving=serving),
                           qkv, [got], h, n, dh, timed)
                extra = rows_plan_line(label, n, h, dh, False)
                if timed:
                    t["k2_ms"] = time_ms(lambda: fused_qkv_attention(
                        qkv, h, serving=serving))
                    extra += f"; K2 at this shape {t['k2_ms']:.4f} ms"
                    if not serving:
                        # the library call has only the exact softmax
                        r = qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
                        t["library_ms"] = time_ms(
                            lambda: F.scaled_dot_product_attention(
                                r[0], r[1], r[2]))
                        extra += f", SDPA {t['library_ms']:.4f} ms"
                record(K6["name"], label, err, t, extra)

    # ---- int8 output: K7 at the p16 shape; K8 at the p32 and p64 shapes;
    #      K9 (flat rows) at the p128 shape, each also at an odd batch. K2
    #      alone (the same body with a bf16 output) and K2 + the plain
    #      quantize (what attn_q8=False runs) at the same shape.
    def q8_case(meta, fn, plain, n, h, dh, b, flat, tweak=None, what="",
                timed=None):
        qkv = randn((b, n, 3 * h * dh))
        if tweak is not None:
            tweak(qkv, h, dh)
        arg = (qkv.reshape(b * n, -1), n, h) if flat else (qkv, h)
        got, want = fn(*arg), plain(*arg)
        label = (f"{meta['name'].replace('fused_qkv_attention', 'attention')} "
                 f"{tuple(arg[0].shape)} n={n} h={h} dh={dh} bf16{what}")
        err, share = compare_q8(label, got, want)
        if timed is None:
            timed = b == KERNEL_BATCH and tweak is None
        t = timing(lambda: fn(*arg), lambda: plain(*arg), qkv, got, h, n, dh,
                   timed)
        extra = f"; codes off by one on a share {share:.2g}"
        if not flat:
            plan, clusters = q8_plan_of_library(n, h, dh)
            check(plan == q8_plan(n, h, dh), f"{label}: the library plans "
                  f"{plan}, ops/cuda/wide_attention.q8_plan {q8_plan(n, h, dh)}")
            check(plan is None or clusters > 0,
                  f"{label}: no cluster of {plan} fits on the card")
            if plan is not None:
                extra += (f"; cluster {plan.cluster} x {plan.heads_per_block} "
                          f"heads, {clusters} clusters at once")
        if flat or q8_plan(n, h, dh) is None:
            extra += rows_plan_line(label, n, h, dh, True)
        if timed:
            t["k2_ms"] = time_ms(lambda: fused_qkv_attention(qkv, h,
                                                             serving=True))
            t["k2_quantize_ms"] = time_ms(lambda: quantize_rows(
                fused_qkv_attention(qkv, h, serving=True)))
            extra += (f"; K2 at this shape {t['k2_ms']:.4f} ms, K2 + plain "
                      f"quantize_rows {t['k2_quantize_ms']:.4f} ms")
        record(meta["name"], label, err, t, extra)
        return qkv, got

    def last_head_dominant(qkv, h, dh):
        qkv[..., 3 * h * dh - dh:] *= 8.0      # v of the last rank's last head

    def zero_image(qkv, h, dh):
        qkv[0, :, 2 * h * dh:] = 0.0            # image 0: v = 0, o = 0

    k7 = (K7, fused_qkv_attention_q8, fused_qkv_attention_q8_reference)
    k8 = (K8, fused_qkv_attention_wide_q8,
          fused_qkv_attention_wide_q8_reference)
    for b in (KERNEL_BATCH, odd):
        q8_case(*k7, 256, 16, 64, b, False)
    for n, h, dh in ((64, 32, 64), (16, 32, 80), (4, 32, 80)):
        for b in (KERNEL_BATCH, odd):
            qkv, (q3, s3) = q8_case(*k8, n, h, dh, b, False)
            if q8_plan(n, h, dh) is None:
                # the flat-row body on the same bytes: equal bit for bit
                q2, s2 = fused_qkv_attention_wide_q8_2d(
                    qkv.reshape(b * n, -1), n, h)
                check(torch.equal(q2, q3.reshape(b * n, -1))
                      and torch.equal(s2, s3.reshape(b * n, 1)),
                      f"K9 differs from K8 at n={n} B={b}")
    print("[kernels] K9 (flat rows) equals K8 bit for bit where both run "
          f"the flat-row body (n = 4, B = {KERNEL_BATCH} and {odd})")
    # K9 at p128's rows at B = 64, 8 and 1 (timed) and an odd batch
    for b in (KERNEL_BATCH, 8, 1, odd):
        q8_case(K9, fused_qkv_attention_wide_q8_2d,
                fused_qkv_attention_wide_q8_2d_reference, 4, 32, 80, b, True,
                timed=b != odd)
    # the cluster body's edges: ragged token counts, a last rank with fewer
    # heads (17 heads: 9 blocks of 2, the last with 1), head counts the
    # cluster does not divide into 16, a dominant last head, zero rows
    for meta, n, h, dh, b in ((k7, 65, 12, 64, 3), (k7, 129, 17, 80, 3),
                              (k7, 255, 24, 64, 2), (k7, 256, 3, 80, 2),
                              (k8, 63, 12, 80, 5), (k8, 16, 17, 64, 3),
                              (k8, 8, 17, 64, 4)):
        q8_case(*meta, n, h, dh, b, False)
    for meta, n, h, dh in ((k7, 256, 16, 64), (k7, 129, 17, 80),
                           (k8, 64, 32, 64)):
        q8_case(*meta, n, h, dh, 5, False, last_head_dominant,
                ", v of the last head x 8")
        _, (q, sc) = q8_case(*meta, n, h, dh, 4, False, zero_image,
                             ", image 0 with v = 0")
        check(bool((sc[0] == 1e-12).all()) and not bool(q[0].any()),
              f"{meta[0]['name']} zero rows: scales {sc[0].unique()} and "
              "codes not 0")
    # the same o: K7's codes times its scales against K2's bf16 output on
    # the same input, elementwise within half a step (the codes' rounding)
    # and K2's own rounding (2^-8 relative); the reciprocal and the
    # products round in fp32, hence the 2^-16 of a step
    qkv = randn((KERNEL_BATCH, 256, 3 * 1024))
    q, sc = fused_qkv_attention_q8(qkv, 16)
    y = fused_qkv_attention(qkv, 16, serving=True).double()
    dev = (q.double() * sc.double() - y).abs()
    lim = 0.5 * sc.double() * (1 + 2.0 ** -16) + 2.0 ** -8 * y.abs()
    check(bool((dev <= lim).all()), "K7 and K2 disagree beyond the "
          f"quantization: worst excess {float((dev - lim).max()):.3g}")
    print(f"[kernels] K7 {tuple(qkv.shape)} h=16: codes x scales within half "
          "a step plus one bf16 rounding of K2 on every element (the same "
          "fp32 o)")

    # ---- float32 (the fp32 policy's forms, path p128_f32): K6 and K9 on
    #      the flat-row body's CUDA-core form at p128's shape (B = 64, 8, 1)
    #      beside SDPA in fp32 (K6's exact form) and K2 fp32 + the plain
    #      quantize_rows (K9), an empty launch on K9's grid; K7 at p16's and
    #      K8 at p32's shape on the tiled forward body's int8 form beside K2
    #      fp32 + quantize_rows; both plans held against the library's; K7 /
    #      K8 either side of the rule and K8 against K9 on the same bytes
    #      (both keep the first design's sums: equal bit for bit)
    f32 = torch.float32
    from tae_tpu_torch.bench.rows_body import empty_library
    from tae_tpu_torch.ops.cuda import build
    from tae_tpu_torch.ops.cuda.wide_attention import (q8_body, q8_f32_plan,
                                                       rows_plan_f32)

    def f32_plan_line(label, n, h, dh, q8, flat) -> str:
        """The fp32 body's plan in the library against the Python mirror."""
        body = q8_body(n, h, dh, f32, flat) if q8 else "rows"
        if body == "image":
            plan, units = q8_plan_of_library(n, h, dh, f32)
            want = q8_f32_plan(n, h, dh)
            what = (f"tiled forward body, cluster {plan.cluster} x "
                    f"{plan.heads_per_block} heads")
        else:
            plan, units = rows_plan_of_library(n, h, dh, q8, f32)
            want = rows_plan_f32(n, h, dh, q8)
            what = (f"flat-row body, {plan.groups} groups of "
                    f"{plan.heads_per_block} heads")
        check(plan is not None and plan == want, f"{label}: the library plans "
              f"{plan}, ops/cuda/wide_attention {want}")
        check(units > 0, f"{label}: no unit of {plan} fits on the card")
        return (f"; {what}, {units} "
                f"{'clusters' if q8 else 'blocks'} at once")

    empty = empty_library()
    for b in (KERNEL_BATCH, 8, 1):
        qkv = torch.randn((b, 4, 3 * 2560), generator=gen, device="cuda")
        for serving in (True, False):
            got = fused_qkv_attention_wide(qkv, 32, serving=serving)
            want = fused_qkv_attention_wide_reference(qkv, 32, serving=serving)
            label = (f"K6 wide {tuple(qkv.shape)} h=32 dh=80 fp32 "
                     f"{'serving' if serving else 'exact'}")
            err = compare(label, got, want, **TOL["float32"])
            t = timing(lambda: fused_qkv_attention_wide(qkv, 32, serving=serving),
                       lambda: fused_qkv_attention_wide_reference(
                           qkv, 32, serving=serving),
                       qkv, [got], 32, 4, 80, True, "fp32")
            extra = f32_plan_line(label, 4, 32, 80, False, True)
            t["k2_ms"] = time_ms(lambda: fused_qkv_attention(qkv, 32, serving=serving))
            extra += f"; K2 fp32 at this shape {t['k2_ms']:.4f} ms"
            if not serving:
                r = qkv.view(b, 4, 3, 32, 80).permute(2, 0, 3, 1, 4)
                t["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                    r[0], r[1], r[2]))
                extra += f"; SDPA (fp32) {t['library_ms']:.4f} ms"
            record(K6["name"], label, err, t, extra)
        # K9 at the same bytes: the int8 form of the same body
        arg = (qkv.reshape(b * 4, -1), 4, 32)
        got = fused_qkv_attention_wide_q8_2d(*arg)
        want = fused_qkv_attention_wide_q8_2d_reference(*arg)
        label = f"attention_wide_q8_2d {tuple(arg[0].shape)} n=4 h=32 dh=80 fp32"
        compare_scales(label, got[1], want[1])
        share = compare_codes(label, got[0], want[0])
        err = float((got[0].float() * got[1] - want[0].float() * want[1]).abs().max())
        t = timing(lambda: fused_qkv_attention_wide_q8_2d(*arg),
                   lambda: fused_qkv_attention_wide_q8_2d_reference(*arg),
                   qkv, got, 32, 4, 80, True, "fp32")
        extra = (f"; codes off by one on a share {share:.2g}"
                 + f32_plan_line(label, 4, 32, 80, True, True))
        plan = rows_plan_f32(4, 32, 80, True)
        t["empty_launch_ms"] = time_ms(lambda: build.check(empty.tae_empty_launch(
            -(-b * 4 // 16), plan.groups, 32 * plan.heads_per_block, plan.cluster,
            torch.cuda.current_stream().cuda_stream), "empty launch"))
        t["k2_quantize_ms"] = time_ms(lambda: quantize_rows(
            fused_qkv_attention(qkv, 32, serving=True)))
        extra += (f"; empty kernel on its grid (cluster {plan.cluster}) "
                  f"{t['empty_launch_ms']:.4f} ms; K2 fp32 + plain quantize_rows "
                  f"{t['k2_quantize_ms']:.4f} ms")
        record(K9["name"], label, err, t, extra)
    for meta, fn, plain, n, h, dh, b in (k7 + (256, 16, 64, KERNEL_BATCH),
                                         k8 + (64, 32, 64, KERNEL_BATCH),
                                         k7 + (32, 16, 64, 3), k7 + (33, 16, 64, 3),
                                         k8 + (32, 32, 80, 3), k8 + (33, 32, 80, 3),
                                         k7 + (255, 5, 80, 2)):
        qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda",
                          dtype=f32)
        (q, sc), (q_ref, s_ref) = fn(qkv, h), plain(qkv, h)
        label = (f"{meta['name'].replace('fused_qkv_attention', 'attention')} "
                 f"{tuple(qkv.shape)} n={n} h={h} dh={dh} fp32")
        compare_scales(label, sc, s_ref)
        share = compare_codes(label, q, q_ref)
        err = float((q.float() * sc - q_ref.float() * s_ref).abs().max())
        timed = b == KERNEL_BATCH
        t = timing(lambda: fn(qkv, h), lambda: plain(qkv, h), qkv, (q, sc),
                   h, n, dh, timed, "fp32")
        extra = (f"; codes off by one on a share {share:.2g}"
                 + f32_plan_line(label, n, h, dh, True, False))
        if n <= 64:
            # K9 on the same bytes: another body at n >= 33, the same sums
            q9, s9 = fused_qkv_attention_wide_q8_2d(qkv.reshape(b * n, -1), n, h)
            check(torch.equal(q9.view_as(q), q) and torch.equal(s9.view_as(sc), sc),
                  f"{label}: K9 on the same bytes gives other codes or scales")
            extra += "; equal to K9's bit for bit"
        if timed:
            t["k2_ms"] = time_ms(lambda: fused_qkv_attention(qkv, h, serving=True))
            t["k2_quantize_ms"] = time_ms(lambda: quantize_rows(
                fused_qkv_attention(qkv, h, serving=True)))
            extra += (f"; K2 fp32 {t['k2_ms']:.4f} ms, K2 fp32 + plain "
                      f"quantize_rows {t['k2_quantize_ms']:.4f} ms")
        record(meta["name"], label, err, t, extra)

    # ---- the serving clamp: every score far below -60 (aligned q rows
    #      against anti-aligned k rows) stays finite and equals the plain form
    n, h, dh = 4, 2, 64
    c = h * dh
    qkv = torch.zeros((6, n, 3 * c), device="cuda")
    qkv[:, :, :c], qkv[:, :, c:2 * c] = 40.0, -40.0
    qkv[:, :, 2 * c:] = torch.randn((6, n, c), generator=gen, device="cuda")
    qkv = qkv.to(bf16)
    for serving in (True, False):
        compare(f"K6 clamp case serving={serving}",
                fused_qkv_attention_wide(qkv, h, serving=serving),
                fused_qkv_attention_wide_reference(qkv, h, serving=serving),
                **tol)
    compare_q8("K8 clamp case", fused_qkv_attention_wide_q8(qkv, h),
               fused_qkv_attention_wide_q8_reference(qkv, h))
    compare_q8("K9 clamp case",
               fused_qkv_attention_wide_q8_2d(qkv.reshape(6 * n, -1), n, h),
               fused_qkv_attention_wide_q8_2d_reference(
                   qkv.reshape(6 * n, -1), n, h))
    print("[kernels] K6, K8, K9 on scores below the clamp: finite, equal to "
          "the plain versions")
    return res


def phase_train_kernels() -> dict:
    """The training kernels against their plain versions: K1's stats form
    (y, mean, rstd), K11 (dx, dw, db), K2's LSE form (o, lse) and K10 (dqkv),
    in bf16 at the train path's shapes (B = 64) and in fp32 at B = 8, plus
    a tensor rank's 8 heads of the p16 shape (``tensor2``), head dim 80, 64
    and 16 tokens and a token count off the 16-row tiles.
    Returns case records per kernel name; the first is the main-path shape."""
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.flash_attention import (
        F32_BWD_TILED_MIN_TOKENS, bwd_f32_plan, bwd_f32_plan_of_library,
        fused_qkv_attention_backward_reference, fused_qkv_attention_bwd,
        fused_qkv_attention_fwd_lse, fused_qkv_attention_lse_reference)
    from tae_tpu_torch.ops.cuda.layernorm import (bwd_plan, bwd_plan_of_library,
                                                  fused_layer_norm_bwd,
                                                  fused_layer_norm_fwd_stats,
                                                  fwd_plan, fwd_plan_of_library)
    from tae_tpu_torch.ops.layernorm import (layer_norm_backward_reference,
                                             layer_norm_stats_reference)
    gen = torch.Generator(device="cuda").manual_seed(1357)
    res = {name: [] for name in ("fused_layer_norm_fwd_stats",
                                 "fused_layer_norm_bwd",
                                 "fused_qkv_attention_fwd_lse",
                                 "fused_qkv_attention_bwd")}

    def randn(shape, dtype, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale + shift).to(dtype)

    def record(kernel, label, err, ms, plain, bnd, lib, lib_name,
               events=None):
        res[kernel].append(dict(case=label, max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=bnd[0],
                                bound_by=bnd[1], library_ms=lib))
        timing = "" if ms is None else (
            f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        lib_s = "" if lib is None else f", {lib_name} {lib:.4f} ms"
        if events is not None:
            res[kernel][-1]["events_ms"] = events
            lib_s += f"; kernel between events as {lib_name} {events:.4f} ms"
        print(f"[kernels] {label}: max_abs_err {err:.3g}{timing}{lib_s}")

    # ---- K1 with stats, K11: the train path's shape, fp32, and the wider
    #      models' widths; p128_train's (32, 2560) timed too. K1's and K11's
    #      launch plans held against the library's at each
    for rows, d, dtype in ((KERNEL_BATCH * 256, 1024, torch.bfloat16),
                           (8 * 256, 1024, torch.float32),
                           (1001, 2560, torch.bfloat16),
                           (8 * 64, 2048, torch.bfloat16),
                           (32, 2560, torch.bfloat16)):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        timed = rows in (KERNEL_BATCH * 256, 32)
        check(bwd_plan_of_library(rows, d) == bwd_plan(rows, d),
              f"K11's plan at ({rows}, {d}): library {bwd_plan_of_library(rows, d)}, "
              f"ops/cuda/layernorm.bwd_plan {bwd_plan(rows, d)}")
        check(fwd_plan_of_library(rows, d) == fwd_plan(rows, d),
              f"K1's plan at ({rows}, {d}): library {fwd_plan_of_library(rows, d)}, "
              f"ops/cuda/layernorm.fwd_plan {fwd_plan(rows, d)}")
        x = randn((rows, d), dtype, 3.0, 1.0)
        w, b = randn((d,), dtype, 1.0, 1.0), randn((d,), dtype)
        dy = randn((rows, d), dtype)
        y, mean, rstd = fused_layer_norm_fwd_stats(x, w, b, 1e-6)
        y_ref, mean_ref, rstd_ref = layer_norm_stats_reference(x, w, b, 1e-6)
        label = f"K1 layer_norm with stats ({rows}, {d}) {name}"
        err = compare(label, y, y_ref, **tol)
        compare(label + " mean", mean, mean_ref, **STATS_TOL)
        compare(label + " rstd", rstd, rstd_ref, **STATS_TOL)
        record("fused_layer_norm_fwd_stats", label, err,
               time_ms(lambda: fused_layer_norm_fwd_stats(x, w, b, 1e-6))
               if timed else None,
               time_ms(lambda: layer_norm_stats_reference(x, w, b, 1e-6))
               if timed else None,
               bound(nbytes(x, w, b, y, mean, rstd), 0.0, "bf16"),
               time_ms(lambda: torch.ops.aten.native_layer_norm(
                   x, [d], w, b, 1e-6)) if timed else None,
               "aten.native_layer_norm (y, mean, rstd)")

        dx, dw, db = fused_layer_norm_bwd(x, w, mean, rstd, dy)
        dx_ref, dw_ref, db_ref = layer_norm_backward_reference(
            x, w, mean, rstd, dy)
        label = f"K11 layer_norm backward ({rows}, {d}) {name}"
        err = compare(label + " dx", dx, dx_ref, **tol)
        grow = rows ** 0.5 / 8 if dtype == torch.bfloat16 else rows ** 0.5
        sum_tol = dict(atol=tol["atol"] * max(1.0, grow), rtol=tol["rtol"])
        err = max(err, compare(label + " dw", dw, dw_ref, **sum_tol),
                  compare(label + " db", db, db_ref, **sum_tol))
        again = fused_layer_norm_bwd(x, w, mean, rstd, dy)
        check(all(torch.equal(a, b_) for a, b_ in zip(again, (dx, dw, db))),
              f"{label}: two runs differ in their bits")
        if timed:
            # one pass over x and dy and the finish: two device launches. A
            # profiler session may lose the card's activity, or some of its
            # kernels: traced takes a new session for a lost one, and a
            # session that kept a count other than two is taken again
            for _ in range(TRACE_TRIES):
                kernels = traced(lambda: fused_layer_norm_bwd(x, w, mean, rstd, dy),
                                 {})["kernels"]
                launched = {k: n for k, n in kernels.items() if "layer_norm_bwd" in k}
                if sum(launched.values()) == 2:
                    break
            check(sum(launched.values()) == 2,
                  f"{label}: one call launched {launched}, expected two kernels")
        lib = None
        if timed:
            # F.layer_norm's backward as one library call on its own saved
            # statistics
            _, lm, lr_ = torch.ops.aten.native_layer_norm(x, [d], w, b, 1e-6)
            lib = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [d], lm, lr_, w, b, [True, True, True]))
        record("fused_layer_norm_bwd", label, err,
               time_ms(lambda: fused_layer_norm_bwd(x, w, mean, rstd, dy))
               if timed else None,
               time_ms(lambda: layer_norm_backward_reference(
                   x, w, mean, rstd, dy)) if timed else None,
               bound(nbytes(x, w, mean, rstd, dy, dx, dw, db), 0.0, "bf16"),
               lib, "F.layer_norm's backward")

    # ---- K2 with LSE, K10 (in bf16, and the fp32 forms at the main path's
    #      shape, timed beside SDPA's fp32 backward); then, untimed, the
    #      token counts at the edges of the bf16 backward body's 16-row tiles
    #      and 128-row ranges
    for batch, n, h, dh, dtype in ((KERNEL_BATCH, 256, 16, 64, torch.bfloat16),
                                   # a rank's share on tensor2's (1, 1, 2)
                                   (KERNEL_BATCH, 256, 8, 64, torch.bfloat16),
                                   (KERNEL_BATCH, 256, 16, 64, torch.float32),
                                   (8, 256, 16, 64, torch.float32),
                                   (KERNEL_BATCH, 64, 32, 64, torch.bfloat16),
                                   (KERNEL_BATCH, 16, 32, 80, torch.bfloat16),
                                   (KERNEL_BATCH, 64, 32, 64, torch.float32),
                                   (KERNEL_BATCH, 16, 32, 80, torch.float32),
                                   (7, 100, 4, 80, torch.bfloat16),
                                   (3, 100, 4, 80, torch.float32),
                                   *(e + (torch.bfloat16,) for e in BWD_EDGES),
                                   *(e + (torch.float32,) for e in F32_BWD_EDGES)):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        timed = batch == KERNEL_BATCH
        c = h * dh
        qkv = randn((batch, n, 3 * c), dtype)
        do = randn((batch, n, c), dtype)
        o, lse = fused_qkv_attention_fwd_lse(qkv, h)
        o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
        shape = f"{tuple(qkv.shape)} h={h} dh={dh} {name}"
        label = f"K2 attention with LSE {shape}"
        err = compare(label, o, o_ref, **tol)
        compare(label + " lse", lse, lse_ref, **STATS_TOL)
        r = qkv.view(batch, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        record("fused_qkv_attention_fwd_lse", label, err,
               time_ms(lambda: fused_qkv_attention_fwd_lse(qkv, h))
               if timed else None,
               time_ms(lambda: fused_qkv_attention_lse_reference(qkv, h))
               if timed else None,
               bound(nbytes(qkv, o, lse), 4.0 * batch * h * n * n * dh,
                     peak_kind(dtype)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   r[0], r[1], r[2])) if timed else None, "SDPA")

        dqkv = fused_qkv_attention_bwd(qkv, o, lse, do, h)
        want = fused_qkv_attention_backward_reference(qkv, o, lse, do, h)
        label = f"K10 attention backward {shape}"
        err = compare(label, dqkv, want, **tol)
        check(torch.equal(dqkv, fused_qkv_attention_bwd(qkv, o, lse, do, h)),
              f"{label}: two runs differ in their bits")
        lib = events = None
        if timed:
            q, k, v = (t.detach().requires_grad_() for t in r)
            so = F.scaled_dot_product_attention(q, k, v)
            sdo = do.view(batch, n, h, dh).transpose(1, 2)
            lib = time_ms_events(lambda: torch.autograd.grad(
                so, (q, k, v), sdo, retain_graph=True))
            # the kernel timed as SDPA's backward is, for a like ratio
            events = time_ms_events(
                lambda: fused_qkv_attention_bwd(qkv, o, lse, do, h))
        record("fused_qkv_attention_bwd", label, err,
               time_ms(lambda: fused_qkv_attention_bwd(qkv, o, lse, do, h))
               if timed else None,
               time_ms(lambda: fused_qkv_attention_backward_reference(
                   qkv, o, lse, do, h)) if timed else None,
               bound(nbytes(qkv, o, lse, do, dqkv),
                     10.0 * batch * h * n * n * dh, peak_kind(dtype)),
               lib, "SDPA's backward", events)

    # the fp32 backward's launch (first design or tiled body, chunk, shared
    # memory) in the library against ops/cuda/flash_attention.bwd_f32_plan
    for dh in (64, 80):
        for n in (1, 16, 33, 55, 56, 64, 129, 248, 249, 252, 253, 256):
            plan = bwd_f32_plan_of_library(n, dh)
            check(plan == bwd_f32_plan(n, dh), f"K10 fp32 n={n} dh={dh}: the "
                  f"library plans {plan}, ops/cuda/flash_attention.bwd_f32_plan "
                  f"{bwd_f32_plan(n, dh)}")
    print("[kernels] K10 / K17 fp32: the library's launch equals bwd_f32_plan at "
          f"n 1-256, dh 64 and 80 (tiled body from {F32_BWD_TILED_MIN_TOKENS} "
          "tokens)")

    # scores far below zero at a ragged token count: every key of a head is
    # one +-1 vector u and every query -25 u, so lse is about -200 and a key
    # beyond n (zero in shared memory, score 0) would have exp(0 - lse) =
    # inf unless the last tile masks it to p = 0
    # (the same in fp32 at 65 tokens: the tiled fp32 body's third 32-key
    # chunk holds one key and 31 zero rows)
    for b, n, h, dh, dtype in ((2, 17, 2, 64, torch.bfloat16),
                               (2, 65, 2, 64, torch.float32)):
        c = h * dh
        u = (torch.randint(0, 2, (1, 1, h, dh), generator=gen, device="cuda") * 2
             - 1).float().expand(b, n, h, dh)
        qkv = torch.cat([(-25.0 * u).reshape(b, n, c), u.reshape(b, n, c),
                         randn((b, n, c), torch.float32)], dim=-1).to(dtype)
        do = randn((b, n, c), dtype)
        o, lse = fused_qkv_attention_fwd_lse(qkv, h)
        name = str(dtype).split(".")[1]
        label = f"K10 attention backward {tuple(qkv.shape)} h={h} {name}, lse " \
                f"{float(lse.max()):.1f} or less"
        dqkv = fused_qkv_attention_bwd(qkv, o, lse, do, h)
        err = compare(label, dqkv, fused_qkv_attention_backward_reference(
            qkv, o, lse, do, h), **TOL[name])
        record("fused_qkv_attention_bwd", label, err, None, None,
               bound(nbytes(qkv, o, lse, do, dqkv), 10.0 * b * h * n * n * dh,
                     peak_kind(dtype)), None, "")
    return res


def phase_int4_kernels() -> dict:
    """K12 and K13 against their plain versions at the int4 paths' shapes:
    width 2560 at 4, 32 and 256 rows (p128 at B = 1, 8, 64), width 1024 at
    16384 rows (p16 at B = 64), and at odd row counts; bf16 and fp32
    outputs. Beside each timed shape: the int8 kernel (K4 / K5) on an int8
    weight of the same shape, and for K12 ``dequantize_int4`` + a bf16
    ``torch.matmul``. Returns case records per kernel; the first is the
    p128 shape at B = 64."""
    import torch

    from tae_tpu_torch.ops.cuda.int4_block import (int4_mlp,
                                                   int4_mlp_reference,
                                                   mlp4_tiles)
    from tae_tpu_torch.ops.cuda.int4_matmul import (int4_matmul_fused,
                                                    int4_matmul_reference,
                                                    pack_int4)
    from tae_tpu_torch.ops.cuda.int8_block import DEFAULT_BLOCK_H, int8_mlp
    from tae_tpu_torch.ops.cuda.int8_matmul import int8_matmul_fused
    from tae_tpu_torch.ops.int4 import dequantize_int4, group_size, int4_ok

    gen = torch.Generator(device="cuda").manual_seed(8642)
    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {K12["name"]: [], K13["name"]: []}
    check(not int4_ok(128) and int4_ok(256) and int4_ok(2560),
          "int4_ok: width 128 must stay int8, 256 and 2560 go int4")

    def randn(shape, scale=1.0, dtype=bf16):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale).to(dtype)

    def rand_i8(shape, lim=127):
        return torch.randint(-lim, lim + 1, shape, generator=gen,
                             device="cuda", dtype=torch.int8)

    def scales(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    def w4(n, k):
        group = group_size(k // 2)
        return pack_int4(rand_i8((n, k), 7)), scales((k // group, n), 2e-3,
                                                     9e-3)

    def record(kernel, label, err, ms, plain, bnd, extra="", **more):
        res[kernel].append(dict(case=label, max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=bnd[0],
                                bound_by=bnd[1], library_ms=None, **more))
        timing = "" if ms is None else (
            f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        print(f"[kernels] {label}: max_abs_err {err:.3g}{timing}{extra}")

    # ---- K12: qkv (+ bias) and proj (+ bias + residual) of both widths
    def k12_case(name, m, k, n, residual, timed=True):
        xq, sx = rand_i8((m, k)), scales((m, 1), 0.01, 0.06)
        wq, ws = w4(n, k)
        b = randn((n,))
        err = 0.0
        for dtype, tol in ((f32, W4_FP32_TOL), (bf16, TOL["bfloat16"])):
            r = randn((m, n), dtype=dtype) if residual else None
            got = int4_matmul_fused(xq, sx, wq, ws, b, r, dtype)
            want = int4_matmul_reference(xq, sx, wq, ws, b, r, dtype)
            label = (f"K12 int4_matmul {name} ({m}, {k}) x ({n}, {k}) group "
                     f"{k // ws.shape[0]} +bias"
                     f"{' +residual' if residual else ''}")
            err = max(err, compare(f"{label} {dtype}", got, want, **tol))
            # the same fp32 terms in the same order: equal bit for bit
            check(torch.equal(got, want), f"{label} {dtype}: not bit-equal "
                                          "to the plain version")
        bnd = bound(nbytes(xq, sx, wq, ws, b, r, got), 2.0 * m * k * n, "int8")
        if not timed:
            return record(K12["name"], label, err, None, None, bnd,
                          "; fp32 and bf16 outputs")
        w8, s8 = rand_i8((n, k)), scales((n,), 1e-4, 5e-4)
        k4 = time_ms(lambda: int8_matmul_fused(xq, sx, w8, s8, b, r, bf16))
        xb = randn((m, k))
        deq = time_ms(lambda: torch.matmul(
            xb, dequantize_int4(wq, ws).to(bf16).t()))
        record(K12["name"], label, err,
               time_ms(lambda: int4_matmul_fused(xq, sx, wq, ws, b, r, bf16)),
               time_ms(lambda: int4_matmul_reference(xq, sx, wq, ws, b, r,
                                                     bf16)), bnd,
               f"; K4 on an int8 weight of this shape {k4:.4f} ms, "
               f"dequantize_int4 + bf16 matmul {deq:.4f} ms",
               k4_ms=k4, dequant_matmul_ms=deq)

    for m in (256, 32, 4):
        k12_case("p128 qkv", m, 2560, 7680, False)
        k12_case("p128 proj", m, 2560, 2560, True)
    k12_case("p16 qkv", KERNEL_BATCH * 256, 1024, 3072, False)
    k12_case("p16 proj", KERNEL_BATCH * 256, 1024, 1024, True)
    for m in (1, 100, 1001):
        k12_case("odd M", m, 512, 1000, True, timed=False)

    # ---- K13
    def k13_case(m, d, timed=True):
        hdim, bh = 4 * d, DEFAULT_BLOCK_H
        xq, sx = rand_i8((m, d)), scales((m, 1), 0.005, 0.025)
        w1, s1 = w4(hdim, d)
        w2, s2 = w4(d, hdim)
        s1, s2 = s1 * 0.03, s2 * 0.03
        b1, b2 = randn((hdim,), 0.1), randn((d,), 0.1)
        groups = mlp4_tiles(m, d, hdim, sms)[2]
        label = (f"K13 int4_mlp ({m}, {d}) hidden {hdim} block_h {bh} "
                 f"hidden groups {groups}")
        # fp32 output: rows that a flipped hidden code moved, counted
        r = randn((m, d), dtype=f32)
        args = (xq, sx, w1, s1, b1, w2, s2, b2, r, bh, f32, groups)
        got, want = int4_mlp(*args).float(), int4_mlp_reference(*args).float()
        diff = (got - want).abs()
        off = (diff > MLP4_FP32_TOL["atol"]
               + MLP4_FP32_TOL["rtol"] * want.abs()).any(dim=1)
        n_off, worst = int(off.sum()), float(diff.max())
        check(bool(torch.isfinite(got).all())
              and n_off <= max(1, int(m * MLP4_FLIP_ROW_SHARE))
              and worst <= MLP4_FLIP_REL * float(want.abs().max()),
              f"{label} fp32: {n_off} rows beyond {MLP4_FP32_TOL}, worst "
              f"|kernel - plain| {worst:.3g} of max |y| "
              f"{float(want.abs().max()):.3g}")
        r = randn((m, d))
        args = (xq, sx, w1, s1, b1, w2, s2, b2, r, bh, bf16, groups)
        got = int4_mlp(*args)
        err = compare(f"{label} bf16", got, int4_mlp_reference(*args),
                      **TOL["bfloat16"])
        extra = (f"; fp32 output: {n_off} of {m} rows moved by a flipped "
                 f"hidden code, worst {worst:.3g}")
        bnd = bound(nbytes(xq, sx, w1, s1, b1, w2, s2, b2, r, got),
                    4.0 * m * d * hdim, "int8")
        if not timed:
            return record(K13["name"], label, err, None, None, bnd, extra)
        w1_8, w2_8 = rand_i8((hdim, d)), rand_i8((d, hdim))
        s1_8, s2_8 = scales((hdim,), 1e-4, 5e-4), scales((d,), 1e-4, 5e-4)
        k5 = time_ms(lambda: int8_mlp(xq, sx, w1_8, s1_8, b1, w2_8, s2_8, b2,
                                      r, bh, bf16))
        record(K13["name"], label, err, time_ms(lambda: int4_mlp(*args)),
               time_ms(lambda: int4_mlp_reference(*args)), bnd,
               extra + f"; K5 on int8 weights of this shape {k5:.4f} ms",
               k5_ms=k5, flipped_rows=n_off)

    for m in (256, 32, 4):
        k13_case(m, 2560)
    k13_case(KERNEL_BATCH * 256, 1024)
    for m in (1, 100):
        k13_case(m, 512, timed=False)
    return res


def compare_ids(label: str, z, codebook, got, want, share: float) -> float:
    """Ids of the codebook search against the plain version's: equal on all
    but ``share`` of the rows, and where they differ the chosen code's
    squared distance (fp64) within VQ_NEAR_TIE_RTOL of the plain version's.
    Returns the share of rows that differ."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype == torch.int64,
          f"{label}: ids {tuple(got.shape)} {got.dtype}")
    k = codebook.shape[0]
    check(int(got.min()) >= 0 and int(got.max()) < k,
          f"{label}: ids outside [0, {k})")
    off = (got != want).reshape(-1)
    differ = float(off.float().mean())
    if off.any():
        zz = z.reshape(-1, z.shape[-1])[off].double()
        c = codebook.detach().to(z.dtype).double()
        d_got = (zz - c[got.reshape(-1)[off]]).square().sum(-1)
        d_want = (zz - c[want.reshape(-1)[off]]).square().sum(-1)
        check(bool((d_got <= d_want * (1 + VQ_NEAR_TIE_RTOL) + 1e-12).all()),
              f"{label}: a differing id is not a near-tie (worst "
              f"{float((d_got / d_want).max()):.6g} x the least distance)")
    check(differ <= share, f"{label}: ids differ on a share {differ:.3g} of "
                           f"the rows (allowed {share})")
    return differ


def phase_vq_kernel() -> dict:
    """K14 against its plain version: the VQ path's shape (256 tokens x
    B = 64, 8, 1 rows of 256-wide latents against 8192 codes) in bf16 and
    fp32, ragged row and code counts, each search's plan edges (its plan
    held against the library's at every case), and an exact tie. Returns
    the case records; the first is the bf16 B = 64 shape."""
    import torch

    from tae_tpu_torch.ops.cuda.quantizer import (CODES as VQ_TILE_CODES,
                                                  F32_CODES, nearest_code,
                                                  nearest_code_reference,
                                                  vq_f32_plan,
                                                  vq_f32_plan_of_library,
                                                  vq_plan, vq_plan_of_library)

    gen = torch.Generator(device="cuda").manual_seed(9753)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []

    def case(m, k, v, dtype, timed):
        name = str(dtype).split(".")[1]
        ours, lib_plan = ((vq_plan, vq_plan_of_library) if dtype == torch.bfloat16
                          else (vq_f32_plan, vq_f32_plan_of_library))
        check(lib_plan(m, v, k, sms) == ours(m, v, k, sms),
              f"K14's {name} plan at ({m}, {v}) x ({k}, {v}): library "
              f"{lib_plan(m, v, k, sms)}, ops/cuda/quantizer {ours(m, v, k, sms)}")
        z = torch.randn((m, v), generator=gen, device="cuda").to(dtype)
        cb = torch.randn((k, v), generator=gen, device="cuda").to(dtype)
        got, want = nearest_code(z, cb), nearest_code_reference(z, cb)
        label = f"K14 nearest_code ({m}, {v}) x ({k}, {v}) {name}"
        differ = compare_ids(label, z, cb, got, want, VQ_ID_SHARE[name])
        ms = plain = lib = None
        if timed:
            ms = time_ms(lambda: nearest_code(z, cb))
            plain = time_ms(lambda: nearest_code_reference(z, cb))
            zf, cf = z.float(), cb.float()
            lib = time_ms(lambda: torch.cdist(zf, cf).argmin(dim=-1))
        bnd = bound(nbytes(z, cb, got), 2.0 * m * k * v, peak_kind(dtype))
        cases.append(dict(case=label, max_abs_err=differ, ms=ms, plain_ms=plain,
                          bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib))
        timing = "" if ms is None else (
            f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} "
            f"ms ({bnd[1]}), torch.cdist + argmin (fp32) {lib:.4f} ms")
        print(f"[kernels] {label}: ids differ on a share {differ:.3g} of the "
              f"rows (allowed {VQ_ID_SHARE[name]}, near-ties only){timing}")

    for dtype in (torch.bfloat16, torch.float32):
        for b in (KERNEL_BATCH, 8, 1):
            case(b * 256, 8192, 256, dtype, True)
    for dtype in (torch.bfloat16, torch.float32):
        case(100, 130, 32, dtype, False)
        case(1000, 777, 1024, dtype, False)
    # the bf16 search's edges: rows one and off a 64-row block, codes one and
    # either side of a 128-code tile, widths of one vector, part of a second
    # 64-column step and past z's resident widths (z rides the ring)
    for m in (1, 65, 129):
        for k in (1, VQ_TILE_CODES - 1, VQ_TILE_CODES + 1):
            for v in (8, 72, 1480):
                case(m, k, v, torch.bfloat16, False)
    print(f"[kernels] K14 bf16 edges: 27 shapes, plans "
          f"{vq_plan(129, 1480, VQ_TILE_CODES + 1, sms)} at the widest")
    # the fp32 search's edges: one row and rows off a 128-row block, codes
    # either side of a 128-code tile, widths of one vector, off a 32-column
    # chunk and past z's resident widths; the codebook split at these rows
    for m in (1, 127, 129):
        for k in (1, F32_CODES - 1, F32_CODES + 1):
            for v in (4, 36, 1028):
                case(m, k, v, torch.float32, False)
    print(f"[kernels] K14 fp32 edges: 27 shapes, plans "
          f"{vq_f32_plan(129, 1028, F32_CODES + 1, sms)} at the widest")
    # one code four times, and all distances equal: the lowest index
    for dtype in (torch.bfloat16, torch.float32):
        cb = torch.randn((700, 64), generator=gen, device="cuda").to(dtype)
        cb[77], cb[300], cb[699] = cb[5], cb[5], cb[5]
        z = cb[5].repeat(40, 1)
        check(bool((nearest_code(z, cb) == 5).all()),
              f"K14 {dtype}: a tie did not go to the lowest index")
        check(int(nearest_code(z, torch.zeros_like(cb)).abs().max()) == 0,
              f"K14 {dtype}: equal distances did not give index 0")
    print("[kernels] K14 ties: the lowest index wins, bf16 and fp32")
    return {K14["name"]: cases}


def phase_last_kernels() -> dict:
    """K15, K16 (both forms), K17, K4's int8_matmul_rows entry (``q8_out``
    and the in-kernel quantize) and K14 at the vocab-4096 and -16384 latent
    widths, against their plain versions at the shapes of the paths that run
    them, timed beside their bounds and yardsticks: SDPA's exact form,
    forward and backward, for K16 and K17; the default int8 route (K4 with a
    bf16 output, then K7) for K4's q8_out + K15. Returns case records per
    wrapper name; the first of each is the main-path shape."""
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_backward_reference,
        flash_attention_bwd, flash_attention_fwd_lse,
        flash_attention_reference, fused_qkv_attention_i8,
        fused_qkv_attention_i8_reference)
    from tae_tpu_torch.ops.cuda.int8_matmul import (
        int8_matmul_fused, int8_matmul_rows, int8_matmul_rows_reference)
    from tae_tpu_torch.ops.cuda.quantizer import (nearest_code,
                                                  nearest_code_reference)
    from tae_tpu_torch.ops.cuda.wide_attention import fused_qkv_attention_q8
    from tae_tpu_torch.ops.int8 import q8_block, row_scales

    gen = torch.Generator(device="cuda").manual_seed(97531)
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("flash_attention", "flash_attention_fwd_lse", "flash_attention_bwd",
             "fused_qkv_attention_i8", "int8_matmul_rows", "nearest_code")
    res = {name: [] for name in names}

    def randn(shape, dtype=bf16, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale).to(dtype)

    def rand_i8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    def record(name, label, err, ms, plain, bnd, lib=None, extra="", **more):
        res[name].append(dict(case=label, max_abs_err=err, ms=ms,
                              plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                              library_ms=lib, **more))
        timing = "" if ms is None else (
            f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} "
            f"ms ({bnd[1]})")
        print(f"[kernels] {label}: max_abs_err {err:.3g}{timing}{extra}")

    # ---- K16 (both forms) and K17: the qknorm_blocks shapes (B = 64 at 256
    #      tokens, 16 x 64; 16 tokens, 32 x 80), the 4-token p128 shape, an
    #      odd token count, fp32; q and k contiguous, v a view of the packed
    #      projection output, as the qk_norm block hands them over
    for b, n, h, dh, dtype in ((KERNEL_BATCH, 256, 16, 64, bf16),
                               (KERNEL_BATCH, 16, 32, 80, bf16),
                               (KERNEL_BATCH, 4, 32, 80, bf16),
                               (7, 100, 4, 80, bf16), (8, 256, 16, 64, f32),
                               (KERNEL_BATCH, 256, 16, 64, f32),
                               (3, 17, 2, 64, f32), (3, 33, 2, 80, f32),
                               (3, 256, 2, 80, f32),
                               *(e + (bf16,) for e in BWD_EDGES)):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        timed = b == KERNEL_BATCH
        qkv = randn((b, n, 3 * h * dh), dtype)
        r = qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
        do = randn((b, h, n, dh), dtype)
        shape = f"(B {b}, H {h}, N {n}, dh {dh}) {name}"
        o_ref, lse_ref = flash_attention_reference(q, k, v)
        ops = 4.0 * b * h * n * n * dh
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v)) \
            if timed else None
        sdpa_s = "" if sdpa is None else f"; SDPA (exact form) {sdpa:.4f} ms"
        o = flash_attention(q, k, v)
        label = f"K16 attention {shape}"
        err = compare(label, o, o_ref, **tol)
        record("flash_attention", label, err,
               time_ms(lambda: flash_attention(q, k, v)) if timed else None,
               time_ms(lambda: flash_attention_reference(q, k, v))
               if timed else None,
               bound(nbytes(q, k, v, o), ops, peak_kind(dtype)), sdpa, sdpa_s)
        o, lse = flash_attention_fwd_lse(q, k, v)
        label = f"K16 attention with LSE {shape}"
        err = compare(label, o, o_ref, **tol)
        compare(label + " lse", lse, lse_ref, **STATS_TOL)
        record("flash_attention_fwd_lse", label, err,
               time_ms(lambda: flash_attention_fwd_lse(q, k, v))
               if timed else None,
               time_ms(lambda: flash_attention_reference(q, k, v))
               if timed else None,
               bound(nbytes(q, k, v, o, lse), ops, peak_kind(dtype)), sdpa,
               sdpa_s)
        got = flash_attention_bwd(q, k, v, o, lse, do)
        want = flash_attention_backward_reference(q, k, v, o, lse, do)
        label = f"K17 attention backward {shape}"
        err = 0.0
        for g, w, which in zip(got, want, ("dq", "dk", "dv")):
            if dtype == f32:
                err = max(err, compare(f"{label} {which}", g, w, **tol))
                continue
            # bf16: P and dS rounded to bf16 ahead of the last three products
            check(g.shape == w.shape and g.dtype == w.dtype
                  and bool(torch.isfinite(g).all()), f"{label} {which}")
            if n == 1 and which != "dv":
                # one key: P = 1 and dS = dP - delta, exactly 0 (so are dq
                # and dk) but for the order of the two fp32 sums
                worst = float(g.float().abs().max())
                check(worst <= 1e-3 * float(got[2].float().abs().max()),
                      f"{label} {which}: {worst:.3g} where the exact value "
                      f"is 0")
                err = max(err, worst)
                continue
            rel = rel_err(g, w)
            check(rel <= K17_BF16_REL, f"{label} {which}: relative error "
                                       f"{rel:.3g} against the fp32 plain "
                                       f"version (bound {K17_BF16_REL})")
            err = max(err, float((g.float() - w.float()).abs().max()))
        again = flash_attention_bwd(q, k, v, o, lse, do)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"{label}: two runs differ in their bits")
        lib = events = None
        more = {}
        if timed:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            so = F.scaled_dot_product_attention(qg, kg, vg)
            lib = time_ms_events(lambda: torch.autograd.grad(
                so, (qg, kg, vg), do, retain_graph=True))
            # the kernel timed as SDPA's backward is, for a like ratio
            more["events_ms"] = events = time_ms_events(
                lambda: flash_attention_bwd(q, k, v, o, lse, do))
        record("flash_attention_bwd", label, err,
               time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do))
               if timed else None,
               time_ms(lambda: flash_attention_backward_reference(
                   q, k, v, o, lse, do)) if timed else None,
               bound(nbytes(q, k, v, o, lse, do, *got), 2.5 * ops,
                     peak_kind(dtype)),
               lib, "" if lib is None else (
                   f"; SDPA's backward {lib:.4f} ms; kernel between events "
                   f"as SDPA's backward {events:.4f} ms"), **more)

    # ---- K4's q8_out form at the p16 qkv shape (and odd rows), the
    #      in-kernel quantize of a float x; K15 on that q8_out output
    m_full, d = KERNEL_BATCH * 256, 1024
    xq, sx = rand_i8((m_full, d)), scales((m_full, 1), 0.01, 0.06)
    wq, sw = rand_i8((3 * d, d)), scales((3 * d,), 1e-4, 5e-4)
    bias = randn((3 * d,))
    bn = q8_block(3 * d)
    for m in (m_full, 1001):
        a = (xq[:m], sx[:m], wq, sw, bias)
        yq, ys = int8_matmul_rows(*a, q8_block=bn)
        yq_ref, ys_ref = int8_matmul_rows_reference(*a, q8_block=bn)
        label = f"K4 int8_matmul q8_out ({m}, {d}) x ({3 * d}, {d}) +bias block {bn}"
        compare_scales(label, ys, ys_ref)
        share = compare_codes(label, yq, yq_ref)
        err = float((yq.float().view(m, -1, bn) * ys.permute(1, 0, 2)
                     - yq_ref.float().view(m, -1, bn)
                     * ys_ref.permute(1, 0, 2)).abs().max())
        timed = m == m_full
        lib = time_ms(lambda: torch._int_mm(xq, wq.t())) if timed else None
        record("int8_matmul_rows", label, err,
               time_ms(lambda: int8_matmul_rows(*a, q8_block=bn))
               if timed else None,
               time_ms(lambda: int8_matmul_rows_reference(*a, q8_block=bn))
               if timed else None,
               bound(nbytes(*a, yq, ys), 2.0 * m * d * 3 * d, "int8"), lib,
               f"; codes off by one on a share {share:.2g}"
               + ("" if lib is None else
                  f"; torch._int_mm (product only) {lib:.4f} ms"))
        if timed:
            qkv_q, qkv_s = yq, ys
    # q8_out at p128's and p32's qkv widths (every tile shape and split of
    # the GEMM body) and at ragged rows with N 8 past a tile
    for m, kk, nn, timed in ((256, 2560, 7680, True), (32, 2560, 7680, True),
                             (4, 2560, 7680, True), (4096, 2048, 6144, True),
                             (1, 1040, 1032, False), (17, 1040, 1032, False),
                             (129, 1040, 1032, False)):
        a = (rand_i8((m, kk)), scales((m, 1), 0.01, 0.06), rand_i8((nn, kk)),
             scales((nn,), 1e-4, 5e-4), randn((nn,)))
        blk = q8_block(nn)
        yq, ys = int8_matmul_rows(*a, q8_block=blk)
        yq_ref, ys_ref = int8_matmul_rows_reference(*a, q8_block=blk)
        label = (f"K4 int8_matmul q8_out ({m}, {kk}) x ({nn}, {kk}) +bias "
                 f"block {blk}")
        compare_scales(label, ys, ys_ref)
        share = compare_codes(label, yq, yq_ref)
        err = float((yq.float().view(m, -1, blk) * ys.permute(1, 0, 2)
                     - yq_ref.float().view(m, -1, blk)
                     * ys_ref.permute(1, 0, 2)).abs().max())
        lib = (time_ms(lambda: torch._int_mm(a[0], a[2].t()))
               if timed and m > 16 else None)
        record("int8_matmul_rows", label, err,
               time_ms(lambda: int8_matmul_rows(*a, q8_block=blk))
               if timed else None,
               time_ms(lambda: int8_matmul_rows_reference(*a, q8_block=blk))
               if timed else None,
               bound(nbytes(*a, yq, ys), 2.0 * m * kk * nn, "int8"), lib,
               f"; codes off by one on a share {share:.2g}"
               + ("" if lib is None else
                  f"; torch._int_mm (product only) {lib:.4f} ms"))
    for m, dtype in ((m_full, bf16), (1001, f32)):
        x = randn((m, d), dtype, 3.0)
        xs = row_scales(x)
        w1, s1 = rand_i8((d, d)), scales((d,), 1e-4, 5e-4)
        b1, r1 = randn((d,)), randn((m, d), dtype)
        a = (x, xs, w1, s1, b1, r1, dtype)
        got, want = int8_matmul_rows(*a), int8_matmul_rows_reference(*a)
        label = (f"K4 int8_matmul in-kernel quantize ({m}, {d}) "
                 f"{str(dtype).split('.')[1]} x ({d}, {d}) +bias +residual")
        err = compare(label, got, want, **TOL[str(dtype).split(".")[1]])
        timed = m == m_full
        record("int8_matmul_rows", label, err,
               time_ms(lambda: int8_matmul_rows(*a)) if timed else None,
               time_ms(lambda: int8_matmul_rows_reference(*a))
               if timed else None,
               bound(nbytes(x, xs, w1, s1, b1, r1, got), 2.0 * m * d * d,
                     "int8"))

    h, dh = 16, 64
    qkv3 = qkv_q.view(KERNEL_BATCH, 256, 3 * d)
    got = fused_qkv_attention_i8(qkv3, qkv_s, h)
    want = fused_qkv_attention_i8_reference(qkv3, qkv_s, h)
    label = f"K15 int8-input attention {tuple(qkv3.shape)} h={h} dh={dh} block {bn}"
    err = compare(label, got, want, **k15_tol(qkv3, qkv_s))
    # the default int8 route it replaces: K4 with a bf16 qkv, then K7
    k15 = time_ms(lambda: fused_qkv_attention_i8(qkv3, qkv_s, h))
    q8_route = time_ms(lambda: fused_qkv_attention_i8(
        int8_matmul_rows(xq, sx, wq, sw, bias, q8_block=bn)[0].view(
            KERNEL_BATCH, 256, 3 * d), qkv_s, h))
    default_route = time_ms(lambda: fused_qkv_attention_q8(
        int8_matmul_fused(xq, sx, wq, sw, bias, None, bf16).view(
            KERNEL_BATCH, 256, 3 * d), h))
    record("fused_qkv_attention_i8", label, err, k15,
           time_ms(lambda: fused_qkv_attention_i8_reference(qkv3, qkv_s, h)),
           bound(nbytes(qkv3, qkv_s, got),
                 4.0 * KERNEL_BATCH * h * 256 * 256 * dh, "bf16"), None,
           f"; yardstick: K4 q8_out + K15 {q8_route:.4f} ms against the "
           f"default route K4 (bf16 qkv) + K7 {default_route:.4f} ms",
           q8_route_ms=q8_route, default_route_ms=default_route)
    for b, n, hh, ddh, blk in ((7, 129, 32, 64, 512), (3, 17, 32, 80, 640)):
        c3 = 3 * hh * ddh
        qkv_o = rand_i8((b, n, c3))
        s_o = scales((c3 // blk, b * n, 1), 0.002, 0.03)
        compare(f"K15 int8-input attention ({b}, {n}, {c3}) h={hh} dh={ddh} "
                f"block {blk}", fused_qkv_attention_i8(qkv_o, s_o, hh),
                fused_qkv_attention_i8_reference(qkv_o, s_o, hh),
                **k15_tol(qkv_o, s_o))

    # ---- K14 over V: p64's 4096-wide latents (16 tokens) and p128 vocab
    #      16384's (4 tokens) at B = 64, against 8192 codes; the ties
    for m, v, dtype, timed in ((KERNEL_BATCH * 16, 4096, bf16, True),
                               (KERNEL_BATCH * 4, 16384, bf16, True),
                               (300, 4096, f32, False),
                               (33, 16384, f32, False)):
        k = 8192 if timed else 777
        name = str(dtype).split(".")[1]
        z, cb = randn((m, v), dtype), randn((k, v), dtype)
        got, want = nearest_code(z, cb), nearest_code_reference(z, cb)
        label = f"K14 nearest_code ({m}, {v}) x ({k}, {v}) {name}, z tiled over V"
        differ = compare_ids(label, z, cb, got, want, VQ_ID_SHARE[name])
        lib = None
        if timed:
            zf, cf = z.float(), cb.float()
            lib = time_ms(lambda: torch.cdist(zf, cf).argmin(dim=-1))
        record("nearest_code", label, differ,
               time_ms(lambda: nearest_code(z, cb)) if timed else None,
               time_ms(lambda: nearest_code_reference(z, cb)) if timed else None,
               bound(nbytes(z, cb, got), 2.0 * m * k * v, peak_kind(dtype)), lib,
               f"; ids differ on a share {differ:.3g}" + (
                   "" if lib is None else
                   f"; torch.cdist + argmin (fp32) {lib:.4f} ms"))
        cb[k - 1], z[0] = cb[3], cb[3]
        check(int(nearest_code(z, cb)[0]) == 3,
              f"{label}: a tie did not go to the lowest index")
    return res


def k15_tol(qkv_q, scales) -> dict:
    """K15 against its plain version: TOL's bf16 bound plus P_FLIP_REL times
    the largest dequantized v (see P_FLIP_REL)."""
    from tae_tpu_torch.ops.cuda.flash_attention import dequantize_qkv

    c = qkv_q.shape[-1] // 3
    vmax = float(dequantize_qkv(qkv_q, scales)[..., 2 * c:].float().abs().max())
    tol = TOL["bfloat16"]
    return dict(atol=tol["atol"] + P_FLIP_REL * vmax, rtol=tol["rtol"])


def slice_tol(base: float, cfg) -> float:
    """The whole-slice bound for a model of cfg.depth blocks per half."""
    return base * max(1.0, cfg.depth / SLICE_TOL_DEPTH)


def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def wrappers() -> dict:
    """The kernel wrappers by name; each counts its launches."""
    from tae_tpu_torch.ops.cuda import counted

    return {f.__name__: f for f in counted()}


@functools.lru_cache(maxsize=None)
def library_kernels() -> "re.Pattern":
    """A pattern that finds, in a kernel's name as the profiler gives it,
    the name of a ``__global__`` function of the port's CUDA sources."""
    return re.compile(r"(?:^|[\s:])(" + "|".join(kernel_names())
                      + r")\s*[<(]")


def kernel_names() -> list[str]:
    """The names of the ``__global__`` functions of the port's CUDA
    sources."""
    from tae_tpu_torch.ops.cuda import build

    names = set()
    for src in build.sources():
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            i = m.end()
            if text.startswith("__launch_bounds__", i):
                i, depth = text.index("(", i), 0
                while True:
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    i += 1
                    if depth == 0:
                        break
            names.add(re.match(r"\s*(\w+)", text[i:]).group(1))
    return sorted(names)


def library_names(names) -> "collections.Counter":
    """The library kernels among kernel ``names`` (demangled, as the
    profiler gives them, or mangled, as the driver does), by the name of
    their ``__global__`` function."""
    pattern = library_kernels()
    mangled = {f"{len(n)}{n}": n for n in kernel_names()}
    found = collections.Counter()
    for name in names:
        m = pattern.search(name)
        if m is not None:
            found[m.group(1)] += 1
        elif name.startswith("_Z"):
            # the length prefix of a mangled name fixes where it ends
            hit = [n for key, n in mangled.items() if key in name]
            if hit:
                found[max(hit, key=len)] += 1
    return found


def graph_kernels(raw: int) -> list[str]:
    """The names of the kernel nodes of the CUDA graph ``raw`` (a
    ``cudaGraph_t``), as the driver gives them (mangled): what each replay
    of it runs."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        check(rc == 0, f"{what}: CUresult {rc}")

    graph, n = ctypes.c_void_p(raw), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2",
                         cu.cuGraphKernelNodeGetParams)
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
        params = (ctypes.c_uint64 * 16)()
        ok(get_params(ctypes.c_void_p(node), params),
           "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])),
               "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name),
                                  ctypes.c_void_p(params[7])),
               "cuKernelGetName")
        names.append(name.value.decode())
    return names


def traced(call, fns: dict) -> dict:
    """The trace of ``call()`` under ``torch.profiler``: the launches of
    each library kernel (``kernels``, :func:`library_names`), every
    kernel, copy and fill on the card by its name (``names``), the CUDA
    graphs launched (``graph_launches``), the device time of every kernel,
    copy and fill summed (``device_ms``), the launches that the wrappers of
    ``fns`` counted in the call (``counted``), and the tries it took
    (``tries``). Now and then a session reports no device activity at
    all, or misses the first kernels the card runs after it starts (the
    first LayerNorm and attention of a p16 decode at B = 1; of an eval
    batch late in a long run, in every session): each session first
    pauses, then runs TRACE_WARM fills, and one that kept none of them may
    have missed the call's first kernels too. Such a trace is lost, not
    short, and the call runs again under a new session, at most
    TRACE_TRIES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for tries in range(1, TRACE_TRIES + 1):
        before = {n: f.launches for n, f in fns.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the pause and the fills ahead of the call, left out below
            time.sleep(TRACE_PAUSE_S)
            warm = torch.zeros(TRACE_WARM, device="cuda")
            for _ in range(TRACE_WARM):
                warm.add_(1)
            torch.cuda.synchronize()
            with record_function(TRACE_RANGE):
                call()
                torch.cuda.synchronize()
        counted = {n: f.launches - before[n] for n, f in fns.items()
                   if f.launches != before[n]}
        events = prof.events()
        start = min(ev.time_range.start for ev in events
                    if ev.name == TRACE_RANGE)
        on_card = [ev for ev in events
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.name != TRACE_RANGE]
        # the range's own device event spans the request's kernels
        device = [ev for ev in on_card if ev.time_range.start >= start]
        warmed = len(on_card) > len(device)
        if device and warmed:
            break
    check(bool(device) and warmed, f"torch.profiler lost the device "
                                   f"activity, or the first kernels, of "
                                   f"{TRACE_TRIES} sessions in a row")
    return dict(
        kernels=library_names(ev.name for ev in device), counted=counted,
        tries=tries, names=collections.Counter(ev.name for ev in device),
        graph_launches=sum(ev.name.startswith("cudaGraphLaunch")
                           for ev in events),
        device_ms=sum(ev.time_range.elapsed_us() for ev in device) / 1e3)


def hold_graph(what: str, raw: int, eager_call, graph_call,
               around=contextlib.nullcontext) -> dict:
    """What a replay really runs. The kernel nodes of the CUDA graph
    ``raw``, read from the graph itself, are what every replay of it runs:
    its library kernels must be those of the same work run eagerly
    (``eager_call()``) under ``torch.profiler``, by name and count, and the
    launches that one traced replay (``graph_call()``) adds to the
    wrappers' counts must be those that the wrappers counted where they
    launched in the eager call. The replay launches one graph. Both calls
    are checks, not the path's: the counts are left as they were, and each
    traced call runs inside ``around()`` (a train step's state put back).
    Returns both traces (``eager``, ``graph``), the graph's library kernels
    (``nodes``) and the eager traces taken (``pairs``)."""
    fns = wrappers()
    nodes = library_names(graph_kernels(raw))
    saved = {n: f.launches for n, f in fns.items()}
    try:
        # a session may also drop a few of its kernels: the eager call is
        # traced again where it disagrees with the graph (whose nodes are
        # read, not traced)
        for pairs in range(1, TRACE_TRIES + 1):
            with around():
                eager = traced(eager_call, fns)
            if eager["kernels"] == nodes:
                break
        with around():
            graph = traced(graph_call, fns)
    finally:
        for n, f in fns.items():
            f.launches = saved[n]
    check(graph["graph_launches"] == 1 and eager["graph_launches"] == 0,
          f"{what}: {graph['graph_launches']} graph launches traced in the "
          f"replay, {eager['graph_launches']} in the eager call")
    check(nodes == eager["kernels"],
          f"{what}: the graph's library kernels {dict(nodes)}, the eager "
          f"call's {dict(eager['kernels'])}")
    check(graph["counted"] == eager["counted"],
          f"{what}: a replay added the launches {graph['counted']}, the "
          f"wrappers counted {eager['counted']} in the eager call")
    return {"eager": eager, "graph": graph, "nodes": nodes, "pairs": pairs}


def check_replay(tag: str, tok, entry: str, x) -> dict:
    """:func:`hold_graph` for ``tok``'s graph of ``entry`` on ``x``'s key
    (``tok`` serves from graphs and has captured it), against the same
    request on a twin of ``tok`` (``cuda_graphs=False``, the same model).
    Returns hold_graph's result and the graph (``captured``)."""
    from tae_tpu_torch.tokenizer import Tokenizer

    what = f"{tag} {entry} {tuple(x.shape)}"
    graphs = [c.graph for k, c in tok._graphs._graphs.items()
              if k[:3] == (entry, tuple(x.shape), x.dtype)]
    check(len(graphs) == 1, f"{what}: {len(graphs)} graphs of the key")
    twin = Tokenizer(model=tok.model, policy=tok.policy, backend=tok.backend,
                     cuda_graphs=False)
    out = hold_graph(what, graphs[0].raw(),
                     lambda: getattr(twin, entry)(x),
                     lambda: getattr(tok, entry)(x))
    return {**out, "captured": graphs[0]}


@contextlib.contextmanager
def preserved(state):
    """``state``'s model and optimizer put back, in place, as they were
    before the block: every parameter, buffer and optimizer state tensor
    (copied back, so that a graph's addresses stay), and each parameter's
    ``.grad``."""
    import torch

    kept = (list(state.model.parameters()) + list(state.model.buffers())
            + [v for st in state.opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor)])
    copies = [t.detach().clone() for t in kept]
    grads = [(p, p.grad) for p in state.model.parameters()]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, c in zip(kept, copies):
                t.copy_(c)
        for p, g in grads:
            p.grad = g


# Every graph that a train step function (make_train_step) or a driver's
# eval function (make_eval_fn) captures while these checks are on has its
# kernel nodes held against the eager work of its key (hold_graph) right
# after its capture (install_graph_checks); the counts per phase are
# printed by ``timed``. Off in the comparisons that count nothing
# (graph_against_eager checks its graphs itself, driver_losses).
GRAPH_CHECKS = {"on": True, "steps": 0, "evals": 0, "nodes": 0, "again": 0,
                "lost": 0}


@contextlib.contextmanager
def graph_checks_off():
    was = GRAPH_CHECKS["on"]
    GRAPH_CHECKS["on"] = False
    try:
        yield
    finally:
        GRAPH_CHECKS["on"] = was


def tally_check(kind: str, tr: dict) -> None:
    GRAPH_CHECKS[kind] += 1
    GRAPH_CHECKS["nodes"] += sum(tr["nodes"].values())
    GRAPH_CHECKS["again"] += tr["pairs"] - 1
    GRAPH_CHECKS["lost"] += tr["eager"]["tries"] + tr["graph"]["tries"] - 2


def check_step_replay(tag: str, graphs, state, batch, it: int) -> dict:
    """:func:`hold_graph` for the step graph of ``graphs`` (a StepGraphs)
    that holds ``state`` on ``batch``'s key, against the same step run
    eagerly by ``graphs`` itself (its device step with the optimizer's host
    part) on the same state; ``state`` is put back after each traced step.
    Returns hold_graph's result and the graph (``captured``)."""
    from tae_tpu_torch.serving_graphs import signature

    key = (id(state.model), id(state.opt), signature(batch))
    captured = graphs._graphs.get(key)
    check(captured is not None, f"{tag}: no graph of the step's key")
    lr = graphs.schedule(it)

    def eager():
        graphs.device_step(state, batch, host=lambda plan: graphs.optimizer
                           .host(state.opt, lr, plan))

    out = hold_graph(tag, captured.graph.raw(), eager,
                     lambda: graphs(state, batch, it),
                     around=lambda: preserved(state))
    check(graphs._graphs.get(key) is captured,
          f"{tag}: the check dropped the step's graph")
    return {**out, "captured": captured}


def install_graph_checks() -> None:
    """Every train step function and driver eval function made from here on
    has each graph it captures checked right after the capture (see
    GRAPH_CHECKS): by subclasses of StepGraphs and of make_eval_fn's
    GraphCache, put where ``make_train_step`` and ``make_eval_fn`` find
    them (the Tokenizer's cache is left alone: its paths check their
    graphs with check_replay)."""
    from tae_tpu_torch.serving_graphs import GraphCache
    from tae_tpu_torch.train import step as step_module
    from tae_tpu_torch.train import step_graphs

    class CheckedStepGraphs(step_graphs.StepGraphs):
        def __call__(self, state, batch, it):
            before = dict(self._graphs)
            out = super().__call__(state, batch, it)
            new = [c for k, c in self._graphs.items() if before.get(k) is not c]
            if GRAPH_CHECKS["on"] and new:
                tally_check("steps", check_step_replay(
                    "step graph check", self, state, batch, it))
            return out

    class CheckedEvalCache(GraphCache):
        def __call__(self, model, key, fn, x):
            before = self._graphs.get(key)
            out = super().__call__(model, key, fn, x)
            captured = self._graphs.get(key)
            if (GRAPH_CHECKS["on"] and captured is not None
                    and captured is not before):
                tally_check("evals", hold_graph(
                    "eval graph check", captured.graph.raw(), lambda: fn(x),
                    lambda: self(model, key, fn, x)))
            return out

    step_graphs.StepGraphs = CheckedStepGraphs
    step_module.GraphCache = CheckedEvalCache


def replay_ms(graph) -> float:
    """Device time of one replay of ``graph`` alone (a graph of the
    ``Tokenizer``'s cache, replayed outside the cache: no input copied, no
    output copied out, no launch counted), between CUDA events, median of
    GRAPH_REPLAYS."""
    import torch

    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def traced_replays(tag: str, tok, inputs: dict) -> None:
    """:func:`check_replay` once per entry and batch size, on
    ``inputs[entry][b]``: the launches that the path's replayed requests
    counted are those of the graphs' kernel nodes."""
    ran, lost, again = {}, 0, 0
    for entry, by_batch in inputs.items():
        for b, x in by_batch.items():
            tr = check_replay(tag, tok, entry, x)
            ran[f"{entry} B={b}"] = sum(tr["nodes"].values())
            lost += tr["eager"]["tries"] + tr["graph"]["tries"] - 2
            again += tr["pairs"] - 1
    print(f"[{tag}] each graph's kernel nodes, read from the graph, are the "
          f"library kernels of the eager request by name and count "
          f"({json.dumps(ran)}); a traced replay launches one graph; the "
          f"launches the graph cache adds for a replay equal those the "
          f"wrappers count in the eager request ({lost} lost traces and "
          f"{again} eager traces disagreeing with the graph taken again)")


def phase_slice(tag: str, tok, per_call: dict, rel_tol: float,
                against=None) -> tuple[dict, dict]:
    """Drive one tokenizer's main path: encode and decode at every batch
    size, one reconstruct. ``per_call`` gives each kernel's launches per
    encode and per decode call, checked on every request. Outputs are held
    against the same tokenizer with ``backend="reference"`` (bound
    ``rel_tol``) and, with ``against = (other tokenizer, bound, what it
    is)``, against that one. Returns (launch counts of the run, latents by
    batch)."""
    import torch

    from tae_tpu_torch.tokenizer import Tokenizer

    fns = wrappers()
    cfg = tok.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = {b: torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                               dtype=torch.uint8, device="cuda", generator=gen)
              for b in BATCHES}

    def counts():
        return {name: f.launches for name, f in fns.items()}

    def request(fn, arg, kinds):
        """One request, timed on the host clock to a synchronize; checks
        that it launched each kernel exactly as often as the path runs it."""
        before = counts()
        t = time.perf_counter()
        out = fn(arg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = counts()
        for name in fns:
            want = sum(per_call[kind].get(name, 0) for kind in kinds)
            got = after[name] - before[name]
            check(got == want, f"{tag} {fn.__name__}: {got} {name} launches, "
                               f"expected {want}")
        return out, dt

    # ---- the main path: every count is 0 here and read right after
    request(tok.encode, images[1], ("encode",))          # warm-up request
    for f in fns.values():
        f.launches = 0
    # each shape's first requests run eagerly and capture its graph; the
    # later ones are timed
    latents, recon, enc_lat, dec_lat = {}, {}, {}, {}
    for b in BATCHES:
        runs = [request(tok.encode, images[b], ("encode",))
                for _ in range(GRAPH_WARM + REQUEST_REPS)]
        latents[b] = runs[-1][0]
        enc_lat[b] = statistics.median(dt for _, dt in runs[GRAPH_WARM:])
    for b in BATCHES:
        runs = [request(tok.decode, latents[b], ("decode",))
                for _ in range(GRAPH_WARM + REQUEST_REPS)]
        recon[b] = runs[-1][0]
        dec_lat[b] = statistics.median(dt for _, dt in runs[GRAPH_WARM:])
    rec_b = BATCHES[1]
    rec, _ = request(tok.reconstruct, images[rec_b], ("encode", "decode"))
    launches = counts()
    if tok.cuda_graphs:
        traced_replays(tag, tok, {"encode": images, "decode": latents})
    on_path = {n for kind in per_call.values() for n, c in kind.items() if c}
    check(all(launches[n] > 0 for n in on_path),
          f"{tag}: a kernel of the path never launched: {launches}")
    print(f"[{tag}] main path launches: {json.dumps(launches)} "
          f"(per call: {json.dumps(per_call)})")

    mode = "graph replays" if tok.cuda_graphs else "eager"
    for b in BATCHES:
        print(f"[{tag}] encode B={b}: {enc_lat[b] * 1e3:.2f} ms/request, "
              f"{b / enc_lat[b]:.1f} img/s; decode B={b}: "
              f"{dec_lat[b] * 1e3:.2f} ms/request, {b / dec_lat[b]:.1f} img/s "
              f"({mode})")

    # ---- outputs: shapes, finiteness, against the plain versions
    ref = Tokenizer(model=tok.model, policy=tok.policy, backend="reference")
    n, v = cfg.num_patches, cfg.vocab_size
    for b in BATCHES:
        z, x = latents[b], recon[b]
        check(tuple(z.shape) == (b, n, v) and z.dtype == torch.bfloat16,
              f"latents {tuple(z.shape)} {z.dtype}")
        check(tuple(x.shape) == (b, 3, cfg.img_size, cfg.img_size),
              f"reconstruction {tuple(x.shape)}")
        check(bool(torch.isfinite(z).all() and torch.isfinite(x).all()),
              f"non-finite output at B={b}")
        ez = rel_err(z, ref.encode(images[b]))
        ex = rel_err(x, ref.decode(z))
        print(f"[{tag}] B={b}: latents rel_err {ez:.3g}, decode rel_err "
              f"{ex:.3g} vs backend='reference' (tolerance {rel_tol:.3g})")
        check(ez <= rel_tol and ex <= rel_tol,
              f"{tag} B={b}: kernels disagree with the plain versions")
        if against is not None:
            other, bound_other, what = against
            ez = rel_err(z, other.encode(images[b]))
            ex = rel_err(x, other.decode(z))
            print(f"[{tag}] B={b}: latents rel_err {ez:.3g}, decode rel_err "
                  f"{ex:.3g} vs {what} on the same weights "
                  f"(tolerance {bound_other})")
            check(ez <= bound_other and ex <= bound_other,
                  f"{tag} B={b}: outputs too far from {what}")
    er = rel_err(rec, ref.reconstruct(images[rec_b]))
    check(tuple(rec.shape) == (rec_b, 3, cfg.img_size, cfg.img_size)
          and er <= rel_tol, f"{tag} reconstruct rel_err {er:.3g}")
    print(f"[{tag}] reconstruct B={rec_b}: rel_err {er:.3g}")
    return launches, latents


def expected_launches(cfg, quantization, attn_q8=None, qkv_q8=False) -> dict:
    """Each kernel's launches per encode and per decode call, as the code
    implies them: the attention entry from the dispatch rule; in bf16 a
    LayerNorm kernel per norm; in int8 every LayerNorm rides a quantizing
    kernel (the MLP epilogue always chains the next LN; the proj epilogue
    chains norm2 where the shape rule allows, else ln_quant runs once more
    per block); in int4 nothing chains: two ln_quant, two int4 matmuls and
    one int4 MLP per block, then the final LayerNorm kernel and the int8
    head (the decoder's embedding is int8 too). ``qkv_q8`` (int8, from 128
    tokens): per block K4's q8_out form for qkv, the int8-input attention,
    K4 for proj on its per-row quantized bf16 input, ln_quant for norm2,
    the MLP (still chaining the next norm1)."""
    from tae_tpu_torch.ops.attention import ROUTES, attention_route
    from tae_tpu_torch.ops.cuda.int8_matmul import ln_chain_rows

    depth = cfg.depth  # decoder depth is equal for every registered config
    if qkv_q8:
        enc = {"ln_quant": 1 + depth, "int8_matmul_rows": depth,
               "fused_qkv_attention_i8": depth, "int8_matmul_fused": depth + 1,
               "int8_mlp": depth}
        return {"encode": enc,
                "decode": dict(enc, int8_matmul_fused=depth + 2)}
    route, _ = attention_route(cfg.num_patches, quantization is not None,
                               True, attn_q8)
    attention = ROUTES[route][0].__name__
    if quantization is None:
        half = {attention: depth, "fused_layer_norm": 2 * depth + 1}
        return {"encode": half, "decode": half}
    if quantization == "int4":
        enc = {"ln_quant": 2 * depth, "int4_matmul_fused": 2 * depth,
               "int4_mlp": depth, attention: depth, "int8_matmul_fused": 1,
               "fused_layer_norm": 1}
        return {"encode": enc, "decode": dict(enc, int8_matmul_fused=2)}
    chained = ln_chain_rows(cfg.embed_dim) is not None
    enc = {"ln_quant": 1 if chained else 1 + depth,
           "int8_matmul_fused": 2 * depth + 1, "int8_mlp": depth,
           attention: depth}
    return {"encode": enc, "decode": dict(enc, int8_matmul_fused=2 * depth + 2)}


def time_attn_q8(tag: str, tok) -> dict:
    """Encode requests at the largest batch with the int8-output attention
    forced on, off, off, on (one card, in turns): median ms per request of
    each setting, launch counts checked. The tokenizer is left on the rule."""
    import torch

    from tae_tpu_torch.tokenizer import set_attn_q8

    fns, cfg, b = wrappers(), tok.model.cfg, BATCHES[-1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                           dtype=torch.uint8, device="cuda", generator=gen)
    times = {True: [], False: []}
    for q8 in (True, False, False, True):
        set_attn_q8(tok.model, q8)
        want = expected_launches(cfg, "int8", q8)["encode"]
        tok.encode(images)
        for _ in range(REQUEST_REPS):
            before = {name: f.launches for name, f in fns.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok.encode(images)
            torch.cuda.synchronize()
            times[q8].append((time.perf_counter() - t) * 1e3)
            got = {name: f.launches - before[name] for name, f in fns.items()}
            check(got == {name: want.get(name, 0) for name in fns},
                  f"{tag} attn_q8={q8}: launches {got}, expected {want}")
    set_attn_q8(tok.model, None)
    on, off = (statistics.median(times[q]) for q in (True, False))
    print(f"[{tag}] encode B={b}: int8-output attention {on:.2f} ms/request "
          f"(runs {min(times[True]):.2f}-{max(times[True]):.2f}); attention in "
          f"bf16 + plain quantize_rows {off:.2f} ms/request (runs "
          f"{min(times[False]):.2f}-{max(times[False]):.2f})")
    return {"attn_q8_ms": on, "bf16_attn_plain_quantize_ms": off}


def train_launches(cfg, remat: bool = False) -> dict:
    """Each kernel's launches in one train step (forward and backward of the
    whole model), as the code implies them: a training LayerNorm forward and
    a LayerNorm backward per norm (two a block and one a half), a training
    attention forward per block and, above 8 tokens, an attention backward
    (the tiny-N entry's backward is plain PyTorch by design); ``remat`` runs
    every block's forward once more. Every forward-only and int8 entry: 0."""
    from tae_tpu_torch.ops.attention import attention_route

    blocks = cfg.depth + cfg.decoder_depth
    again = blocks if remat else 0
    want = {"fused_layer_norm_fwd_stats": 2 * blocks + 2 + 2 * again,
            "fused_layer_norm_bwd": 2 * blocks + 2}
    if attention_route(cfg.num_patches, False, False)[0] == "wide":
        want["fused_qkv_attention_wide"] = blocks + again
    else:
        want["fused_qkv_attention_fwd_lse"] = blocks + again
        want["fused_qkv_attention_bwd"] = blocks
    return want


def counted_step(tag: str, step, state, batch, it: int, want: dict, totals: dict):
    """One train step, timed on the host clock to a synchronize, with every
    kernel's launch count held to ``want`` and added into ``totals``."""
    import torch

    fns = wrappers()
    before = {name: f.launches for name, f in fns.items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, metrics = step(state, batch, it)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = {name: f.launches - before[name] for name, f in fns.items()}
    check(got == {name: want.get(name, 0) for name in fns},
          f"{tag} step {it}: launches {got}, expected {want}")
    for name, n in got.items():
        totals[name] = totals.get(name, 0) + n
    return metrics, dt


def compare_gradients(tag: str, model, ref_model, tol: float) -> float:
    """Relative Frobenius error of every gradient tensor of ``model`` against
    ``ref_model``'s, the worst returned; fails above ``tol``."""
    import torch

    worst, worst_name = 0.0, ""
    grads = dict(model.named_parameters())
    for (name, p), q in zip(model.named_parameters(), ref_model.parameters()):
        check(p.grad is not None and q.grad is not None
              and p.grad.dtype == torch.float32
              and bool(torch.isfinite(p.grad).all()),
              f"{tag}: gradient of {name} is missing, not fp32 or not finite")
        if name.endswith("attn.k_norm.bias"):
            # its exact gradient is zero (a shift of every key of a head
            # moves a query's scores by one constant): rounding noise on
            # both sides, held small against k_norm's weight's gradient
            scale = float(grads[name[:-4] + "weight"].grad.norm())
            noise = max(float(p.grad.norm()), float(q.grad.norm()))
            check(noise <= ZERO_GRAD_REL * scale,
                  f"{tag}: gradient of {name} is {noise:.3g}, not ~0 against "
                  f"{scale:.3g}")
            continue
        err = rel_err(p.grad, q.grad)
        if err > worst:
            worst, worst_name = err, name
    print(f"[{tag}] gradients vs backend='reference': worst relative error "
          f"{worst:.3g} ({worst_name}; tolerance {tol})")
    check(worst <= tol, f"{tag}: gradient of {worst_name} is {worst:.3g} from "
                        "the plain versions'")
    return worst


def phase_train(kres: dict) -> dict:
    """Path ``train_bf16``. Returns the launch counts of its steps."""
    import gc
    import tempfile

    import torch

    from tae_tpu_torch.ckpt.io import (checkpoint_step, load_train_state,
                                       save_checkpoint)
    from tae_tpu_torch.profile_training import build_state, make_step

    tag, name = "train_bf16", PATHS[0][0]
    fns = wrappers()
    state, step = build_state(name), make_step()
    cfg = state.model.cfg
    n_params = sum(p.numel() for p in state.model.parameters())
    check(all(p.requires_grad and p.dtype == torch.float32
              for p in state.model.parameters()), "parameters are not fp32 "
                                                  "with a gradient")
    print(f"[{tag}] {name}: {n_params} fp32 parameters, {cfg.depth}+"
          f"{cfg.decoder_depth} blocks, bf16 compute, AdamW (weight decay "
          f"0.05), fused={state.opt.param_groups[0]['fused']}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    size = (cfg.in_chans, cfg.img_size, cfg.img_size)
    small = torch.randn((8, *size), generator=gen, device="cuda")
    batch = torch.randn((TRAIN_BATCH, *size), generator=gen, device="cuda")
    want, totals = train_launches(cfg), {}

    # ---- 1. one step at B = 8, kernels vs the plain versions (a warm-up too)
    ref_state, ref_step = build_state(name), make_step(backend="reference")
    ref_state.model.load_state_dict(state.model.state_dict())
    m, _ = counted_step(tag, step, state, small, 0, want, {})
    m_ref, _ = counted_step(tag, ref_step, ref_state, small, 0, {}, {})
    loss, loss_ref = float(m["loss"]), float(m_ref["loss"])
    print(f"[{tag}] B=8 step: loss {loss:.6f} vs {loss_ref:.6f} with "
          f"backend='reference' (rtol {TRAIN_LOSS_RTOL}); grad_norm "
          f"{float(m['grad_norm']):.4f} vs {float(m_ref['grad_norm']):.4f}")
    check(abs(loss - loss_ref) <= TRAIN_LOSS_RTOL * abs(loss_ref),
          f"{tag}: losses differ")
    compare_gradients(tag, state.model, ref_state.model, TRAIN_GRAD_REL_TOL)
    del ref_state, ref_step, m_ref
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2-4. the main path: eight steps at B = 64 on one batch; every
    #      count is 0 here and read right after each step
    for f in fns.values():
        f.launches = 0
    losses, times, resumed, norm5 = [], [], None, None
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "latest.pt"
        for it in range(1, TRAIN_STEPS + 1):
            if it == 5:
                # 3. the checkpoint of step 4 in a fresh model and optimizer
                save_checkpoint(path, state, step=4, args={"batch": TRAIN_BATCH})
                check(checkpoint_step(path) == 4, "checkpoint_step")
                resumed = build_state(name, seed=99)
                _, restored, meta = load_train_state(path, resumed.model,
                                                     resumed.opt)
                check(restored and meta["step"] == 4,
                      f"{tag}: optimizer state not restored ({meta})")
            m, dt = counted_step(tag, step, state, batch, it, want, totals)
            losses.append(float(m["loss"]))
            times.append(dt)
            if it == 5:
                norm5 = float(m["grad_norm"])
                m2, _ = counted_step(tag, step, resumed, batch, it, want, {})
                same = (float(m2["loss"]) == losses[-1] and all(
                    torch.equal(a, b) for a, b in zip(
                        state.model.parameters(), resumed.model.parameters())))
                check(same, f"{tag}: step 5 from the loaded checkpoint differs "
                            f"from the running state's (loss {float(m2['loss'])}"
                            f" vs {losses[-1]})")
                print(f"[{tag}] resume: step 5 from the checkpoint of step 4 "
                      f"equals the running state bit for bit (loss "
                      f"{losses[-1]:.6f}, {n_params} parameters)")
                # 4. accum_iter = 2 from the same weights, on the same images
                acc_step = make_step(accum_iter=2)
                load_train_state(path, resumed.model, resumed.opt)
                acc_want = {k: 2 * v for k, v in want.items()}
                m3, _ = counted_step(tag, acc_step, resumed, batch, it,
                                     acc_want, {})
                norm2 = float(m3["grad_norm"])
                print(f"[{tag}] accum_iter=2: grad_norm {norm2:.6f} vs "
                      f"{norm5:.6f} with accum_iter=1 (rtol {ACCUM_NORM_RTOL}); "
                      f"loss {float(m3['loss']):.6f} vs {losses[-1]:.6f}")
                check(abs(norm2 - norm5) <= ACCUM_NORM_RTOL * norm5,
                      f"{tag}: accum_iter=2 changes the gradient norm")
                del resumed, acc_step, m2, m3
                gc.collect()
                torch.cuda.empty_cache()
                # the peak of the steps that follow is one trainer's own
                torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(x == x and abs(x) != float("inf") for x in losses)
          and losses[-1] < losses[0],
          f"{tag}: losses {losses} are not finite and decreasing")
    print(f"[{tag}] {TRAIN_STEPS} steps at B={TRAIN_BATCH}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}")
    on_path = [k for k, v in want.items() if v]
    check(all(totals.get(k, 0) > 0 for k in on_path),
          f"{tag}: a kernel of the path never launched: {totals}")
    ran = {k: v for k, v in totals.items() if v}
    print(f"[{tag}] main path launches: {json.dumps(ran)} (per step: "
          f"{json.dumps(want)})")

    def report(label, times, peak, per_step):
        ms = statistics.median(times) * 1e3
        inside = sum(kres[k][0]["ms"] * n for k, n in per_step.items()
                     if k in kres)
        # a graph's activations lie in its pool, allocated at its capture
        # and reserved since: the allocated peak of replays leaves them out
        reserved = torch.cuda.max_memory_reserved() / 2 ** 30
        print(f"[{tag}] {label}: {ms:.2f} ms/step (runs "
              f"{min(times) * 1e3:.2f}-{max(times) * 1e3:.2f}), "
              f"{TRAIN_BATCH / ms * 1e3:.1f} img/s at B={TRAIN_BATCH}, peak "
              f"memory allocated {peak:.2f} GiB, reserved {reserved:.2f} GiB "
              f"(the step graph's pool); K10 + K11 + K1 + K2 (kernel-phase "
              f"times x launches) {inside:.2f} ms = {inside / ms:.3f} of the "
              "step")
        return ms

    report("no remat", times[1:], peak, want)

    # ---- 5. remat=True: the same state, each block's forward once more
    remat_step = make_step(remat=True)
    remat_want, remat_totals, times = train_launches(cfg, remat=True), {}, []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for it in range(TRAIN_STEPS + 1, TRAIN_STEPS + 1 + REMAT_STEPS):
        m, dt = counted_step(tag, remat_step, state, batch, it, remat_want,
                             remat_totals)
        losses.append(float(m["loss"]))
        times.append(dt)
    check(all(x == x for x in losses) and losses[-1] < losses[0],
          f"{tag}: losses with remat {losses[TRAIN_STEPS:]}")
    report("remat=True", times, torch.cuda.max_memory_allocated() / 2 ** 30,
           remat_want)
    print(f"[{tag}] remat launches per step: {json.dumps(remat_want)}")
    del step, remat_step
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. remat="dots" / "dots_no_batch"; 7. the dynamic loss scale on
    #      the last step's gradients
    timed(f"{tag} remat policies", train_policies, tag, state, batch,
          TRAIN_STEPS + REMAT_STEPS + 1, report)
    grads = [p.grad.detach().clone() for p in state.model.parameters()]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    timed("scaler", phase_scaler, tag, grads)
    return totals


def gemm_launches(names) -> int:
    """cuBLAS's launches among the kernel ``names`` of a trace (a Counter,
    :func:`traced`'s ``names``)."""
    port = library_kernels()
    return sum(n for name, n in names.items()
               if GEMM_KERNEL.search(name) and not port.search(name))


def train_policies(tag: str, state, batch, it: int, report) -> None:
    """``remat="dots"`` and ``"dots_no_batch"`` on ``train_bf16``: from one
    saved state (parameters, AdamW moments, step counts) one eager step in
    each of the four remat modes, put back after each: loss, gradient norm
    and the updated state bit-equal to ``remat=False``'s, the launches of
    ``remat=True`` under both policies, the allocated peak over the state's
    ordered ``True`` < ``"dots"`` = ``"dots_no_batch"`` < ``False``, and in
    a traced step of each mode cuBLAS's launches: a policy's those of
    ``remat=False``, ``remat=True``'s three a block more (the forward's
    products but fc2's again). Then REMAT_STEPS steps under each policy,
    from CUDA graphs as the main path's, launches checked, timed through
    ``report``."""
    import gc

    import torch

    from tae_tpu_torch.nn.vit import REMAT_POLICIES
    from tae_tpu_torch.profile_training import make_step

    cfg = state.model.cfg
    fns = wrappers()
    modes = (False, True, *REMAT_POLICIES)
    first, peaks, gemms, walls = None, {}, {}, {}
    for mode in modes:
        eager = make_step(remat=mode, cuda_graphs=False)
        want = train_launches(cfg, remat=mode is not False)
        with preserved(state):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            m, walls[mode] = counted_step(tag, eager, state, batch, it, want,
                                          {})
            peaks[mode] = (
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                torch.cuda.max_memory_reserved() / 2 ** 30)
            got = (float(m["loss"]), float(m["grad_norm"]))
            now = [t for _, t in training_tensors(state)]
            if first is None:
                first = (got, [t.detach().clone() for t in now])
            unequal = sum(not torch.equal(a, b) for a, b in zip(now, first[1]))
            check(got == first[0] and unequal == 0,
                  f"{tag} remat={mode!r}: (loss, grad_norm) {got} against "
                  f"{first[0]} with remat=False, {unequal} of {len(now)} "
                  "parameters, moments and step counts not bit-equal")
        # the same step traced, put back after; its launches are a check's
        saved = {n: f.launches for n, f in fns.items()}

        def again(eager=eager):
            with preserved(state):
                eager(state, batch, it)

        gemms[mode] = gemm_launches(traced(again, fns)["names"])
        for n, f in fns.items():
            f.launches = saved[n]
    del first
    blocks = cfg.depth + cfg.decoder_depth
    label = {m: f"remat={m!r}" for m in modes}
    print(f"[{tag}] one eager step in each remat mode from one saved state "
          f"at B={TRAIN_BATCH}: loss, grad_norm and every parameter, moment "
          "and step count bit-equal to remat=False's; " + "; ".join(
              f"{label[m]} host wall {walls[m] * 1e3:.2f} ms (the first step "
              "of its step function, eager), peak allocated over the "
              f"state {peaks[m][0]:.3f} GiB, reserved {peaks[m][1]:.3f} GiB, "
              f"{gemms[m]} cuBLAS launches" for m in modes))
    alloc = {m: peaks[m][0] for m in modes}
    check(alloc[True] < alloc["dots"] < alloc[False]
          and alloc["dots_no_batch"] == alloc["dots"],
          f"{tag}: the allocated peaks {alloc} are not ordered remat=True < "
          "'dots' = 'dots_no_batch' < False")
    # remat=True reruns qkv, proj and fc1 of each block; its recompute
    # stops before fc2, whose output no backward formula reads
    check(gemms["dots"] == gemms["dots_no_batch"] == gemms[False]
          and gemms[True] == gemms[False] + 3 * blocks,
          f"{tag}: cuBLAS launches a step {gemms}; expected remat=False's "
          f"under the policies and {3 * blocks} more with remat=True")
    print(f"[{tag}] cuBLAS launches a traced step: the policies rerun none "
          f"({gemms['dots']} = {gemms[False]} without remat), remat=True "
          f"reruns {3 * blocks} forward products, qkv, proj and fc1 of each "
          f"block ({gemms[True]})")

    want = train_launches(cfg, remat=True)
    for name in REMAT_POLICIES:
        step, totals, times, losses = make_step(remat=name), {}, [], []
        gc.collect()
        for k in range(REMAT_STEPS):
            if k == 2:
                # eager step, capture and its graph check are behind: the
                # peaks from here are the replays' (the graph's pool held)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            m, dt = counted_step(tag, step, state, batch, it + k, want, totals)
            losses.append(float(m["loss"]))
            times.append(dt)
        check(all(math.isfinite(x) for x in losses),
              f"{tag} remat={name!r}: losses {losses}")
        report(f"remat={name!r}", times,
               torch.cuda.max_memory_allocated() / 2 ** 30, want)
        print(f"[{tag}] remat={name!r} launches in {REMAT_STEPS} steps: "
              f"{json.dumps({k: v for k, v in totals.items() if v})} (per "
              f"step, as remat=True: {json.dumps(want)})")
        del step
        it += REMAT_STEPS


def phase_scaler(tag: str, grads: list) -> None:
    """``train.scaler.DynamicLossScale`` on ``tag``'s gradient list (one
    fp32 tensor a parameter), as a scaled loss's gradients (times
    SCALER_INIT): eagerly and from a captured CUDA graph, three steps from
    one state, a finite one, the one that reaches ``growth_interval``
    (SCALER_GROWTH) and one with an ``inf`` written into a gradient. The
    graph's scale, tracker, ``finite`` and unscaled gradients bit-equal to
    eager's at each step; the graph's kernel nodes those of the eager call
    (:func:`hold_graph`; none is the port's, so by count as well); the host
    µs of an eager call and of a replay, each to a synchronize."""
    import torch

    from tae_tpu_torch.serving_graphs import CudaGraph
    from tae_tpu_torch.train.scaler import DynamicLossScale, ScalerState

    scaler = DynamicLossScale(growth_interval=SCALER_GROWTH)
    scaled = [g * SCALER_INIT for g in grads]
    bad = [g.clone() for g in scaled]
    bad[len(bad) // 2].view(-1)[0] = float("inf")
    kinds = (("finite", scaled), ("growth", scaled), ("inf", bad))
    state = ScalerState.create(SCALER_INIT, device="cuda")
    eager = []
    for _, g in kinds:
        out, state, finite = scaler.unscale_and_update(state, g)
        eager.append((out, finite.clone(), state.scale.clone(),
                      state.growth_tracker.clone()))
    got = [(bool(f), float(sc), int(tr)) for _, f, sc, tr in eager]
    check(got == [(True, SCALER_INIT, 1), (True, 2 * SCALER_INIT, 0),
                  (False, SCALER_INIT, 0)]
          and not any(bool(t.any()) for t in eager[2][0]),
          f"{tag} scaler: (finite, scale, tracker) {got}, or the inf step's "
          "gradients not zeroed")

    static = [g.clone() for g in scaled]
    gstate = ScalerState.create(SCALER_INIT, device="cuda")

    def start():
        gstate.scale.fill_(SCALER_INIT)
        gstate.growth_tracker.zero_()

    scaler.unscale_and_update(gstate, static)      # an eager first call
    start()
    graph = CudaGraph()
    gout, _, gfinite = graph.capture(
        lambda: scaler.unscale_and_update(gstate, static), None)
    for (kind, g), (out, finite, scale, tracker) in zip(kinds, eager):
        for dst, src in zip(static, g):
            dst.copy_(src)
        graph.replay()
        same = (torch.equal(gfinite, finite)
                and torch.equal(gstate.scale, scale)
                and torch.equal(gstate.growth_tracker, tracker)
                and all(torch.equal(a, b) for a, b in zip(gout, out)))
        check(same, f"{tag} scaler: the {kind} step's replay differs from "
                    "the eager call")

    twin = ScalerState.create(SCALER_INIT, device="cuda")

    @contextlib.contextmanager
    def kept():
        was = [t.clone() for t in (*gstate, *twin)]
        try:
            yield
        finally:
            for t, w in zip((*gstate, *twin), was):
                t.copy_(w)

    held = hold_graph(f"{tag} scaler", graph.raw(),
                      lambda: scaler.unscale_and_update(twin, static),
                      graph.replay, around=kept)
    kernels = sum(n for name, n in held["eager"]["names"].items()
                  if not name.startswith(("Memcpy", "Memset")))
    nodes = len(graph_kernels(graph.raw()))
    check(nodes == kernels, f"{tag} scaler: {nodes} kernel nodes in the "
                            f"graph, {kernels} kernels in the eager call")

    def host_us(fn) -> float:
        runs = []
        with kept():
            for _ in range(SCALER_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t) * 1e6)
        return statistics.median(runs)

    eager_us = host_us(lambda: scaler.unscale_and_update(twin, static))
    replay_us = host_us(graph.replay)
    print(f"[{tag} scaler] DynamicLossScale(growth_interval={SCALER_GROWTH})"
          f" on {len(grads)} gradient tensors "
          f"({sum(g.numel() for g in grads)} fp32 values) scaled by "
          f"{SCALER_INIT:g}: a finite step (tracker 1), the step that grows "
          "the scale (x2, tracker 0), a step with one inf (scale / 2, "
          "gradients zeroed); a CUDA graph's replays bit-equal to eager "
          f"(scale, tracker, finite, every gradient) at each; the graph's "
          f"{nodes} kernel nodes are the eager call's kernels; host to a "
          f"synchronize, median of {SCALER_REPS}: eager {eager_us:.1f} us, "
          f"replay {replay_us:.1f} us")


def phase_train_f32() -> dict:
    """Path TRAIN_F32_PATH: tae_patch16_vocab256_px256 at depth 2 + 2 under
    the FP32 policy, AdamW and train_bf16's recipe: one step at B = 8
    against a second copy with backend="reference" (loss and every gradient
    tensor), then TRAIN_F32_STEPS steps at B = 64, each step's launches
    checked (K10 and K2's LSE form in fp32 4 each, K1's stats form and K11
    at the LayerNorm count); the step time at B = 64. Returns the path's
    launch counts."""
    import gc

    import torch

    from tae_tpu_torch.profile_training import build_state, make_step
    from tae_tpu_torch.utils.dtypes import FP32

    tag, name = TRAIN_F32_PATH, PATHS[0][0]
    cut = dict(depth=2, decoder_depth=2)
    fns = wrappers()
    state, step = build_state(name, **cut), make_step(policy=FP32)
    cfg = state.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(8)
    size = (cfg.in_chans, cfg.img_size, cfg.img_size)
    small = torch.randn((8, *size), generator=gen, device="cuda")
    batch = torch.randn((TRAIN_BATCH, *size), generator=gen, device="cuda")
    want, totals = train_launches(cfg), {}
    blocks = cfg.depth + cfg.decoder_depth
    check(want.get("fused_qkv_attention_bwd") == blocks
          and want.get("fused_qkv_attention_fwd_lse") == blocks,
          f"{tag}: a step runs {want}")
    print(f"[{tag}] {name} at depth {cfg.depth}+{cfg.decoder_depth}, width "
          f"{cfg.embed_dim}, {cfg.num_patches} tokens, fp32 parameters and "
          f"compute, AdamW; per step {json.dumps(want)}")

    # ---- the main path: every count is 0 here and read right after each
    #      step; first one step at B = 8 against the plain versions
    ref_state = build_state(name, **cut)
    ref_step = make_step(policy=FP32, backend="reference")
    ref_state.model.load_state_dict(state.model.state_dict())
    for f in fns.values():
        f.launches = 0
    m, dt8 = counted_step(tag, step, state, small, 0, want, totals)
    m_ref, _ = counted_step(tag, ref_step, ref_state, small, 0, {}, {})
    loss, loss_ref = float(m["loss"]), float(m_ref["loss"])
    print(f"[{tag}] B=8 step: loss {loss:.8f} vs {loss_ref:.8f} with "
          f"backend='reference' (relative {abs(loss - loss_ref) / abs(loss_ref):.3g}, "
          f"rtol {TRAIN_F32_LOSS_RTOL})")
    check(abs(loss - loss_ref) <= TRAIN_F32_LOSS_RTOL * abs(loss_ref),
          f"{tag}: losses differ")
    compare_gradients(tag, state.model, ref_state.model, TRAIN_F32_GRAD_REL_TOL)
    del ref_state, ref_step, m_ref
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for it in range(1, TRAIN_F32_STEPS + 1):
        m, dt = counted_step(tag, step, state, batch, it, want, totals)
        losses.append(float(m["loss"]))
        times.append(dt)
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"{tag}: losses {losses} are not finite")
    ms = statistics.median(times[1:]) * 1e3
    print(f"[{tag}] {TRAIN_F32_STEPS} steps at B={TRAIN_BATCH}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; {ms:.2f} ms/step (runs "
          f"{min(times[1:]) * 1e3:.2f}-{max(times[1:]) * 1e3:.2f}), "
          f"{TRAIN_BATCH / ms * 1e3:.1f} img/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    ran = {k: v for k, v in totals.items() if v}
    check(all(totals.get(k, 0) > 0 for k, v in want.items() if v),
          f"{tag}: a kernel of the path never launched: {ran}")
    print(f"[{tag}] main path launches: {json.dumps(ran)}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_p128_f32() -> dict:
    """Path P128_F32_PATH: tae_patch128_vocab4096_px256 at depth 2 + 2
    through Tokenizer(dtype=torch.float32): encode and decode at every batch
    size (K6 in fp32, one a block), each call's launches checked, latents
    and reconstructions against backend="reference" (F32_SLICE_REL_TOL);
    then its int8 tokenizer on the same weights with fp32 activations (K9 in
    fp32, one a block) against its own reference and the float one. Returns
    the path's launch counts."""
    import gc

    import torch

    from tae_tpu_torch.tokenizer import Tokenizer

    tag, name = P128_F32_PATH, PATHS[1][0]
    cut = dict(depth=2, decoder_depth=2)
    fns = wrappers()
    tok = Tokenizer.from_checkpoint(name, dtype=torch.float32, device="cuda",
                                    seed=0, **cut)
    tok8 = Tokenizer.from_checkpoint(name, dtype=torch.float32, device="cuda",
                                     seed=0, quantization="int8", **cut)
    cfg = tok.model.cfg
    per_call = expected_launches(cfg, None)
    per_call8 = expected_launches(cfg, "int8")
    check(per_call["encode"].get("fused_qkv_attention_wide") == cfg.depth
          and per_call8["encode"].get("fused_qkv_attention_wide_q8_2d") == cfg.depth,
          f"{tag}: an encode runs {per_call['encode']} / {per_call8['encode']}")
    print(f"[{tag}] {name} at depth {cfg.depth}+{cfg.decoder_depth} in fp32, "
          f"width {cfg.embed_dim}, {cfg.num_patches} tokens; per encode "
          f"{json.dumps(per_call['encode'])}; int8 with fp32 activations "
          f"{json.dumps(per_call8['encode'])}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    images = {b: torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                               dtype=torch.uint8, device="cuda", generator=gen)
              for b in BATCHES}
    totals = {}

    def request(fn, arg, want):
        return counted_request(tag, fns, totals, fn, arg, want)

    tok.encode(images[1])                                # warm-up requests
    tok8.encode(images[1])
    for f in fns.values():
        f.launches = 0
    n, v = cfg.num_patches, cfg.vocab_size
    for t, calls, rtol, what in ((tok, per_call, F32_SLICE_REL_TOL, "fp32"),
                                 (tok8, per_call8, INT8_SLICE_REL_TOL,
                                  "int8, fp32 activations")):
        ref = Tokenizer(model=t.model, policy=t.policy, backend="reference")
        zs = {}
        for b in BATCHES:
            runs = [request(t.encode, images[b], calls["encode"])
                    for _ in range(GRAPH_WARM + REQUEST_REPS)][GRAPH_WARM:]
            z = zs[b] = runs[-1][0]
            check(tuple(z.shape) == (b, n, v) and z.dtype == torch.float32
                  and bool(torch.isfinite(z).all()),
                  f"{tag} {what} B={b}: latents {tuple(z.shape)} {z.dtype}")
            dec = [request(t.decode, z, calls["decode"])
                   for _ in range(GRAPH_WARM + REQUEST_REPS)][GRAPH_WARM:]
            x = dec[-1][0]
            check(bool(torch.isfinite(x).all()), f"{tag} {what} B={b}: decode")
            ez, ex = rel_err(z, ref.encode(images[b])), rel_err(x, ref.decode(z))
            line = (f"[{tag}] {what} B={b}: encode "
                    f"{statistics.median(dt for _, dt in runs) * 1e3:.2f} ms, "
                    f"decode {statistics.median(dt for _, dt in dec) * 1e3:.2f} "
                    f"ms/request; latents rel_err {ez:.3g}, decode rel_err "
                    f"{ex:.3g} vs backend='reference' (tolerance {rtol})")
            check(ez <= rtol and ex <= rtol,
                  f"{tag} {what} B={b}: kernels disagree with the plain versions")
            if t is tok8:
                ez = rel_err(z, tok.encode(images[b]))
                line += (f"; latents rel_err {ez:.3g} vs the fp32 tokenizer "
                         f"(tolerance {INT8_VS_BF16_TOL})")
                check(ez <= INT8_VS_BF16_TOL, f"{tag} B={b}: int8 too far from fp32")
            print(line)
        traced_replays(f"{tag} {what}", t, {"encode": images, "decode": zs})
        del ref
    ran = {k: c for k, c in totals.items() if c}
    check(totals.get("fused_qkv_attention_wide", 0) > 0
          and totals.get("fused_qkv_attention_wide_q8_2d", 0) > 0,
          f"{tag}: K6 or K9 never launched: {ran}")
    print(f"[{tag}] main path launches: {json.dumps(ran)}")
    del tok, tok8
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_p128_train() -> dict:
    """Path ``p128_train``: one step of the 4-token model at depth 2 + 2,
    B = 8, through the tiny-N attention entry (forward kernel, backward by
    the plain reference), gradients against ``backend="reference"``."""
    import gc

    import torch

    from tae_tpu_torch.profile_training import build_state, make_step

    tag, name = "p128_train", PATHS[1][0]
    cut = dict(depth=2, decoder_depth=2)
    state, step = build_state(name, **cut), make_step()
    ref_state, ref_step = build_state(name, **cut), make_step(backend="reference")
    ref_state.model.load_state_dict(state.model.state_dict())
    cfg = state.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = torch.randn((8, cfg.in_chans, cfg.img_size, cfg.img_size),
                        generator=gen, device="cuda")
    want, totals = train_launches(cfg), {}
    for f in wrappers().values():
        f.launches = 0
    m, dt = counted_step(tag, step, state, batch, 0, want, totals)
    m_ref, _ = counted_step(tag, ref_step, ref_state, batch, 0, {}, {})
    loss, loss_ref = float(m["loss"]), float(m_ref["loss"])
    print(f"[{tag}] {name} at depth 2+2, width {cfg.embed_dim}, "
          f"{cfg.num_patches} tokens, B=8: loss {loss:.6f} vs {loss_ref:.6f} "
          f"with backend='reference'; launches "
          f"{json.dumps({k: v for k, v in totals.items() if v})}; first "
          f"step {dt * 1e3:.1f} ms")
    check(loss == loss and abs(loss - loss_ref) <= TRAIN_LOSS_RTOL * loss_ref,
          f"{tag}: losses differ")
    check(totals.get("fused_qkv_attention_wide", 0) > 0,
          f"{tag}: the tiny-N entry never launched")
    compare_gradients(tag, state.model, ref_state.model, TRAIN_GRAD_REL_TOL)
    del state, ref_state
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_qknorm(kres: dict) -> dict:
    """Path ``qknorm_blocks``: qk_norm block stacks driven through
    ``nn.vit.blocks_apply`` (no registered model has qk_norm), fp32
    parameters from a seeded generator (every LayerNorm affine then moved
    off the identity, seeded), bf16 activations. The flagship encoder's
    blocks (width 1024, 16 heads, 15 deep) at 256 tokens, B = 64, and a
    2-block stack of p64's blocks (width 2560, 32 x 80) at 16 tokens: a
    serving forward and one train step (forward, backward, AdamW) each, with
    every kernel's launches checked, outputs and gradients held against
    ``backend="reference"``, then QKNORM_STEPS timed steps. Returns the
    launch counts of the path's own forwards and steps."""
    import copy
    import gc

    import torch

    from tae_tpu_torch.nn import vit
    from tae_tpu_torch.train import adamw

    tag, fns, totals = "qknorm_blocks", wrappers(), {}
    gen = torch.Generator(device="cuda").manual_seed(6)

    def counted(fn, want):
        before = {k: f.launches for k, f in fns.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = {k: f.launches - before[k] for k, f in fns.items()}
        check(got == {k: want.get(k, 0) for k in fns},
              f"{tag}: launches {got}, expected {want}")
        for k, c in got.items():
            totals[k] = totals.get(k, 0) + c
        return out, dt

    for dim, heads, depth, n in QKNORM_STACKS:
        cfg = vit.BlockConfig(dim, heads, 4.0, qkv_bias=True, qk_norm=True)
        stack = vit.blocks(cfg, depth, device="cuda")
        vit.init_weights_(stack, gen)
        with torch.no_grad():
            for m in stack.modules():
                if isinstance(m, vit.LayerNorm):
                    m.weight.mul_(torch.rand(m.weight.shape, generator=gen,
                                             device="cuda") * 0.7 + 0.7)
                    m.bias.normal_(0.0, 0.1, generator=gen)
        x = torch.randn((KERNEL_BATCH, n, dim), generator=gen,
                        device="cuda").bfloat16()
        label = (f"{depth} blocks, width {dim}, {heads} x {dim // heads}, "
                 f"{n} tokens, B={KERNEL_BATCH}")
        tol = SLICE_REL_TOL * max(1.0, depth / SLICE_TOL_DEPTH)

        # ---- serving forward: K16 per block, K1 per norm (four per block)
        serve = {"flash_attention": depth, "fused_layer_norm": 4 * depth}
        with torch.no_grad():
            counted(lambda: vit.blocks_apply(stack, x, serving=True), serve)
            y, dt = counted(lambda: vit.blocks_apply(stack, x, serving=True),
                            serve)
            err = rel_err(y, vit.blocks_apply(stack, x, backend="reference"))
        check(bool(torch.isfinite(y).all()) and err <= tol,
              f"{tag} {label}: serving forward rel_err {err:.3g}")
        print(f"[{tag}] {label}: serving forward {dt * 1e3:.2f} ms, rel_err "
              f"{err:.3g} vs backend='reference' (tolerance {tol:.3g}); "
              f"launches {json.dumps(serve)}")

        # ---- one train step against a copy on the plain versions
        stack.requires_grad_(True)
        ref = copy.deepcopy(stack)
        opt = adamw(weight_decay=0.05)
        state = opt.init(stack)
        train = {"flash_attention_fwd_lse": depth, "flash_attention_bwd": depth,
                 "fused_layer_norm_fwd_stats": 4 * depth,
                 "fused_layer_norm_bwd": 4 * depth}

        def step(s, backend=None):
            loss = vit.blocks_apply(s, x, backend=backend).float().square().mean()
            loss.backward()
            return loss.detach()

        loss, _ = counted(lambda: step(stack), train)
        loss_ref = step(ref, "reference")
        check(abs(float(loss) - float(loss_ref))
              <= TRAIN_LOSS_RTOL * abs(float(loss_ref)),
              f"{tag} {label}: losses {float(loss)} vs {float(loss_ref)}")
        compare_gradients(f"{tag} {label}", stack, ref, TRAIN_GRAD_REL_TOL)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        before = {k: p.detach().clone() for k, p in stack.named_parameters()}
        opt.update(state, 1e-4)
        # every parameter moves but k_norm's bias (whose gradient is noise)
        check(all(bool(torch.isfinite(p).all()) and (
            k.endswith("k_norm.bias") or not torch.equal(p, before[k]))
            for k, p in stack.named_parameters()),
              f"{tag} {label}: AdamW left a parameter unchanged or non-finite")
        del before
        times = []
        for _ in range(QKNORM_STEPS):
            state.zero_grad(set_to_none=True)

            def full_step():
                step(stack)
                opt.update(state, 1e-4)

            _, dt = counted(full_step, train)
            times.append(dt)
        ms = statistics.median(times) * 1e3
        inside = sum(kres[k][0]["ms"] * c for k, c in train.items()
                     if k in kres and kres[k][0]["ms"] is not None) \
            if n == 256 else None
        share = "" if inside is None else (
            f"; K16 + K17 + K1 + K11 (kernel-phase times x launches) "
            f"{inside:.2f} ms = {inside / ms:.3f} of the step")
        print(f"[{tag}] {label}: loss {float(loss):.6f} vs {float(loss_ref):.6f} "
              f"with backend='reference'; train step (forward, backward, "
              f"AdamW) {ms:.2f} ms (runs {min(times) * 1e3:.2f}-"
              f"{max(times) * 1e3:.2f}), launches per step "
              f"{json.dumps(train)}{share}")
        del stack, state, opt, x, y
        gc.collect()
        torch.cuda.empty_cache()
    ran = {k: v for k, v in totals.items() if v}
    print(f"[{tag}] main path launches: {json.dumps(ran)}")
    return totals


def time_qkv_q8(tag: str, tok) -> dict:
    """Encode requests at the largest batch with ``qkv_q8`` on, off, off, on
    (one card, in turns): median ms per request of each setting, launch
    counts checked. The tokenizer is left with the switch on."""
    import torch

    from tae_tpu_torch.tokenizer import set_qkv_q8

    fns, cfg, b = wrappers(), tok.model.cfg, BATCHES[-1]
    gen = torch.Generator(device="cuda").manual_seed(7)
    images = torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                           dtype=torch.uint8, device="cuda", generator=gen)
    times = {True: [], False: []}
    for on in (True, False, False, True):
        set_qkv_q8(tok.model, on)
        want = expected_launches(cfg, "int8", qkv_q8=on)["encode"]
        tok.encode(images)
        for _ in range(REQUEST_REPS):
            before = {name: f.launches for name, f in fns.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok.encode(images)
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t) * 1e3)
            got = {name: f.launches - before[name] for name, f in fns.items()}
            check(got == {name: want.get(name, 0) for name in fns},
                  f"{tag} qkv_q8={on}: launches {got}, expected {want}")
    set_qkv_q8(tok.model, True)
    on, off = (statistics.median(times[q]) for q in (True, False))
    print(f"[{tag}] encode B={b}: qkv_q8 on (K4 q8_out + K15) {on:.2f} "
          f"ms/request (runs {min(times[True]):.2f}-{max(times[True]):.2f}); "
          f"off (the default int8 route) {off:.2f} ms/request (runs "
          f"{min(times[False]):.2f}-{max(times[False]):.2f})")
    return {"qkv_q8_ms": on, "default_int8_ms": off}


def phase_graphs(tag: str, tok, per_call: dict, label: str,
                 totals: dict) -> None:
    """The ``graphs`` phase on one path's tokenizer: at every batch size and
    for each entry of ``per_call`` (``encode`` / ``decode``, or the discrete
    pair), a Tokenizer serving from CUDA graphs against one with
    ``cuda_graphs=False`` on the same model: outputs bit for bit (the
    graph's eager request, its capture and a replay), the host wall per
    request (to a synchronize), medians of GRAPH_ROUNDS x GRAPH_PER_ROUND
    requests of each mode in turns (eager, graph, graph, eager, ...), peak
    memory above what was allocated before, and every request's launches
    against ``per_call``; then one request of each mode traced
    (:func:`check_replay`, which holds the graph's kernel nodes against the
    eager request's kernels): its kernels, copies and fills summed; and
    the graph replayed alone between CUDA events (:func:`replay_ms`).
    Times the graph cache's check that the model is unchanged, which every
    request of a graph tokenizer runs. Adds the requests' launches to
    ``totals``."""
    import gc

    import torch

    from tae_tpu_torch.serving_graphs import _unchanged
    from tae_tpu_torch.tokenizer import Tokenizer

    fns = wrappers()
    cfg = tok.model.cfg
    modes = {mode: Tokenizer(model=tok.model, policy=tok.policy,
                             backend=tok.backend, cuda_graphs=mode == "graph")
             for mode in ("eager", "graph")}
    check(tok.cuda_graphs and modes["graph"].cuda_graphs
          and not modes["eager"].cuda_graphs,
          f"{tag}: a CUDA tokenizer does not serve from graphs by default")
    gen = torch.Generator(device="cuda").manual_seed(13)
    entries = list(per_call)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()

    def request(t, entry, x):
        """(output, host ms) of one request, its launches checked."""
        before = {n: f.launches for n, f in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = getattr(t, entry)(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = {n: f.launches - before[n] for n, f in fns.items()}
        want = per_call[entry]
        check(got == {n: want.get(n, 0) for n in fns},
              f"[graphs] {tag} {entry}: launches {got}, expected {want}")
        for n, c in got.items():
            totals[n] = totals.get(n, 0) + c
        return out, wall

    for b in BATCHES:
        images = torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                               dtype=torch.uint8, device="cuda", generator=gen)
        # a decode's input is the eager encode's output (not counted)
        inputs = {"encode": images, "encode_discrete": images}
        if "decode" in per_call:
            inputs["decode"] = modes["eager"].encode(images)
        if "decode_discrete" in per_call:
            inputs["decode_discrete"] = modes["eager"].encode_discrete(images)
        for entry in entries:
            x = inputs[entry]
            want, _ = request(modes["eager"], entry, x)
            peak = {}
            for mode in ("eager", "graph"):
                gc.collect()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                for i in range(GRAPH_WARM + 1):   # eager, capture, replay
                    out, _ = request(modes[mode], entry, x)
                    check(torch.equal(out, want),
                          f"[graphs] {tag} {entry} B={b}: {mode} request "
                          f"{i} differs from cuda_graphs=False")
                peak[mode] = (torch.cuda.max_memory_allocated() - base) / 2**20
            walls = {"eager": [], "graph": []}
            for r in range(GRAPH_ROUNDS):
                for mode in (("eager", "graph") if r % 2 == 0
                             else ("graph", "eager")):
                    for _ in range(GRAPH_PER_ROUND):
                        out, wall = request(modes[mode], entry, x)
                        walls[mode].append(wall)
                    check(torch.equal(out, want),
                          f"[graphs] {tag} {entry} B={b}: a {mode} replay "
                          "differs from cuda_graphs=False")
            med = {m: statistics.median(walls[m]) for m in walls}
            n = sum(per_call[entry].values())
            print(f"[graphs] {tag} {entry} B={b}: host wall eager "
                  f"{med['eager']:.3f} ms, graph {med['graph']:.3f} ms "
                  f"({med['eager'] / med['graph']:.2f}x), medians of "
                  f"{GRAPH_ROUNDS * GRAPH_PER_ROUND} requests each, in turns "
                  f"({label})")
            tr = check_replay(tag, modes["graph"], entry, x)
            lib = sum(tr["nodes"].values())
            print(f"[graphs] {tag} {entry} B={b}: device time, the graph "
                  f"replayed alone between CUDA events "
                  f"{replay_ms(tr['captured']):.3f} ms (median of "
                  f"{GRAPH_REPLAYS}); kernels, copies and fills of one "
                  f"traced request summed (torch.profiler) eager "
                  f"{tr['eager']['device_ms']:.3f} ms, graph "
                  f"{tr['graph']['device_ms']:.3f} ms; the graph's {lib} "
                  f"library kernel nodes are the eager request's by name and "
                  f"count ({tr['pairs']} eager traces) ({label})")
            print(f"[graphs] {tag} {entry} B={b}: peak memory above the "
                  f"allocated before, eager {peak['eager']:.1f} MiB, graph "
                  f"(its eager request, capture and a replay) "
                  f"{peak['graph']:.1f} MiB; {n} launches a request in both "
                  f"modes; graph output bit-equal to cuda_graphs=False "
                  f"({label})")
    cache = modes["graph"]._graphs
    t0 = time.perf_counter()
    for _ in range(UNCHANGED_REPS):
        _unchanged(cache._snap)
    walk_us = (time.perf_counter() - t0) * 1e6 / UNCHANGED_REPS
    print(f"[graphs] {tag}: the check that the model is unchanged, over "
          f"{len(cache._snap)} parameters, buffers and submodules, takes "
          f"{walk_us:.1f} us of host time a request (mean of "
          f"{UNCHANGED_REPS}) ({label})")
    captured = len(cache)
    check(captured == len(BATCHES) * len(entries),
          f"[graphs] {tag}: {captured} graphs captured, expected "
          f"{len(BATCHES) * len(entries)}")
    gc.collect()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - reserved) / 2**20
    print(f"[graphs] {tag}: the {captured} graphs of {', '.join(entries)} at "
          f"B = {', '.join(map(str, BATCHES))} hold {held:.1f} MiB between "
          f"requests (their pool and static buffers) ({label})")
    del modes
    gc.collect()
    torch.cuda.empty_cache()


def phase_paths() -> dict:
    """Every model of PATHS: its bf16 tokenizer (driven where PATHS names a
    bf16 path, and the yardstick of the quantized outputs), then its int8
    and / or int4 tokenizer on the same weights; each path of GRAPH_PATHS
    then runs the graphs phase on its tokenizer. Returns each path's launch
    counts, the graphs phase's under "graphs"."""
    import gc

    import torch

    from tae_tpu_torch.nn.vit import Q4Linear, QLinear
    from tae_tpu_torch.tokenizer import Tokenizer

    launches, graphs, label = {}, {}, card_label()
    for name, overrides, paths in PATHS:
        def build(**kw):
            t0 = time.perf_counter()
            tok = Tokenizer.from_checkpoint(name, dtype=torch.bfloat16,
                                            device="cuda", seed=0, **overrides,
                                            **kw)
            torch.cuda.synchronize()
            return tok, time.perf_counter() - t0

        tok, secs = build()
        cfg = tok.model.cfg
        n_params = sum(p.numel() for p in tok.model.parameters())
        print(f"[paths] {name}: {n_params} params, width {cfg.embed_dim}, "
              f"{cfg.depth}+{cfg.decoder_depth} blocks, {cfg.num_heads} heads "
              f"of {cfg.embed_dim // cfg.num_heads}, {cfg.num_patches} tokens, "
              f"bf16, built in {secs:.1f} s")
        tok8 = None
        for tag, quantization in paths.items():
            if quantization is None:
                per_call = expected_launches(cfg, None)
                launches[tag], _ = phase_slice(tag, tok, per_call,
                                               slice_tol(SLICE_REL_TOL, cfg))
                if tag in GRAPH_PATHS:
                    phase_graphs(tag, tok, per_call, label, graphs)
                continue
            if quantization == "int8_qkv_q8":
                # beside the default int8 tokenizer built just before
                tokq, secs = build(quantization="int8", qkv_q8=True)
                print(f"[{tag}] int8 with qkv_q8=True, built and quantized in "
                      f"{secs:.1f} s")
                per_call = expected_launches(cfg, "int8", qkv_q8=True)
                launches[tag], _ = phase_slice(
                    tag, tokq, per_call, slice_tol(INT8_SLICE_REL_TOL, cfg),
                    against=(tok8, QKV_Q8_VS_INT8_TOL,
                             "the default int8 tokenizer"))
                time_qkv_q8(tag, tokq)          # leaves qkv_q8 on
                if tag in GRAPH_PATHS:
                    phase_graphs(tag, tokq, per_call, label, graphs)
                del tokq
                continue
            tok8 = None                # one quantized model at a time
            tok8, secs = build(quantization=quantization)
            n_q, n_q4 = (sum(isinstance(m, form) for m in tok8.model.modules())
                         for form in (QLinear, Q4Linear))
            print(f"[{tag}] {n_q} int8 linears (w8a8), {n_q4} int4 linears "
                  f"(w4a8), MLP block_h {tok8.model.blocks[0].mlp.block_h}, "
                  f"built and quantized in {secs:.1f} s")
            per_call = expected_launches(cfg, quantization)
            if quantization == "int4":
                check(n_q4 == 4 * (cfg.depth + cfg.decoder_depth) and n_q == 3,
                      f"{tag}: {n_q4} int4 and {n_q} int8 linears")
                launches[tag], _ = phase_slice(
                    tag, tok8, per_call, slice_tol(INT4_SLICE_REL_TOL, cfg),
                    against=(tok, INT4_VS_BF16_TOL, "the bf16 tokenizer"))
            else:
                launches[tag], _ = phase_slice(
                    tag, tok8, per_call, slice_tol(INT8_SLICE_REL_TOL, cfg),
                    against=(tok, INT8_VS_BF16_TOL, "the bf16 tokenizer"))
                time_attn_q8(tag, tok8)         # leaves attn_q8 on the rule
            if tag in GRAPH_PATHS:
                phase_graphs(tag, tok8, per_call, label, graphs)
        # the next model needs the memory: p128 is initialised in fp32
        del tok, tok8
        gc.collect()
        torch.cuda.empty_cache()
    launches["graphs"] = graphs
    return launches


def codebook_from(z, k: int, gen, replace: bool = False):
    """k codes on the scale of latent rows z (M, V), each a row of z plus
    seeded noise of a tenth of z's spread. ``replace``: the rows drawn with
    replacement, so several noisy copies of a row compete for it. Else
    distinct rows, and where k > M the rest drawn at z's spread around zero,
    far from every row."""
    import torch

    m, v = z.shape
    std = z.std()
    if replace:
        rows = z[torch.randint(0, m, (k,), generator=gen, device=z.device)]
    else:
        rows = z[torch.randperm(m, generator=gen, device=z.device)[:k]]
    if k > m and not replace:
        far = torch.randn((k - m, v), generator=gen, device=z.device) * std
        rows = torch.cat([rows, far])
    noise = torch.randn((k, v), generator=gen, device=z.device)
    return rows + 0.1 * std * noise


def counted_request(tag: str, fns: dict, totals: dict, fn, arg, want: dict):
    """One request fn(arg), timed on the host clock between synchronizes:
    checks that it launched each wrapper of ``fns`` exactly as often as
    ``want`` says and adds its launches to ``totals``. Returns (output,
    seconds)."""
    import torch

    before = {n: f.launches for n, f in fns.items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(arg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = {n: f.launches - before[n] for n, f in fns.items()}
    check(got == {n: want.get(n, 0) for n in fns},
          f"{tag} {fn.__name__}: launches {got}, expected {want}")
    for n, c in got.items():
        totals[n] = totals.get(n, 0) + c
    return out, dt


def phase_vq(tag: str, graphs: dict) -> dict:
    """Path ``tag`` of VQ_PATHS: discrete tokens through the VQ bottleneck
    (and, for a path of GRAPH_PATHS, the graphs phase on its tokenizer,
    its launches added to ``graphs``), then one train step with it. Returns
    the launch counts of the path's own requests and step (the comparisons'
    launches are not counted)."""
    import gc

    import torch

    from tae_tpu_torch.profile_training import build_state, make_step
    from tae_tpu_torch.tokenizer import Tokenizer

    name, overrides = VQ_PATHS[tag]
    fns = wrappers()
    tok = Tokenizer.from_checkpoint(name, dtype=torch.bfloat16, device="cuda",
                                    seed=0, **overrides)
    cfg, codebook = tok.model.cfg, tok.model.codebook
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = {b: torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                               dtype=torch.uint8, device="cuda", generator=gen)
              for b in BATCHES}
    check(tuple(codebook.shape) == (cfg.codebook_size, cfg.vocab_size)
          and float(codebook.float().abs().max()) <= 1.0 / cfg.codebook_size,
          f"{tag}: codebook {tuple(codebook.shape)} is not the seeded init")
    # A codebook on the latents' own scale: the init above (+-1/8192) makes
    # every distance ~0 and, in bf16, every row a near-tie, which would
    # compare nothing. Rows of a seeded batch's latents plus seeded noise.
    z0 = tok.encode(images[BATCHES[-1]]).reshape(-1, cfg.vocab_size).float()
    with torch.no_grad():
        codebook.copy_(codebook_from(z0, cfg.codebook_size, gen))
    print(f"[{tag}] {name} at depth {cfg.depth}+{cfg.decoder_depth}, "
          f"quantize=True, codebook {tuple(codebook.shape)} {codebook.dtype} "
          f"from seeded latents + noise (std {float(z0.std()):.3g})")

    totals = {}

    def request(fn, arg, want):
        return counted_request(tag, fns, totals, fn, arg, want)

    per_call = expected_launches(cfg, None)
    enc_want = dict(per_call["encode"], nearest_code=1)
    tok.encode_discrete(images[1])                       # warm-up request
    for f in fns.values():
        f.launches = 0
    ref = Tokenizer(model=tok.model, policy=tok.policy, backend="reference")
    for b in BATCHES:
        runs = [request(tok.encode_discrete, images[b], enc_want)
                for _ in range(GRAPH_WARM + REQUEST_REPS)]
        ids = runs[-1][0]
        enc_ms = statistics.median(dt for _, dt in runs[GRAPH_WARM:]) * 1e3
        check(tuple(ids.shape) == (b, cfg.num_patches)
              and ids.dtype == torch.int64 and int(ids.min()) >= 0
              and int(ids.max()) < cfg.codebook_size,
              f"{tag} B={b}: ids {tuple(ids.shape)} {ids.dtype}")
        rec, dt = request(tok.decode_discrete, ids, per_call["decode"])
        check(tuple(rec.shape) == (b, 3, cfg.img_size, cfg.img_size)
              and bool(torch.isfinite(rec).all()),
              f"{tag} B={b}: reconstruction {tuple(rec.shape)}")
        # the comparisons: their launches stay out of the path's totals
        z = tok.encode(images[b])
        check(torch.equal(tok.encode_discrete(z), ids),
              f"{tag} B={b}: ids of latents differ from ids of their images")
        differ = compare_ids(f"{tag} B={b}", z, codebook, ids,
                             ref.encode_discrete(z), VQ_ID_SHARE["bfloat16"])
        check(torch.equal(rec, tok.decode(codebook[ids])),
              f"{tag} B={b}: decode_discrete(ids) != decode(codebook[ids])")
        print(f"[{tag}] B={b}: encode_discrete {enc_ms:.2f} ms/request, "
              f"decode_discrete {dt * 1e3:.2f} ms; ids {tuple(ids.shape)} "
              f"differ from backend='reference' on a share {differ:.3g} of "
              f"the rows (near-ties); {int(ids.unique().numel())} codes used; "
              "decode_discrete equals decode(codebook[ids]) bit for bit")
    traced_replays(tag, tok, {"encode_discrete": images})
    if tag in GRAPH_PATHS:
        phase_graphs(tag, tok, {"encode_discrete": enc_want,
                                "decode_discrete": per_call["decode"]},
                     card_label(), graphs)
    del tok, ref
    gc.collect()
    torch.cuda.empty_cache()

    # one train step through the bottleneck (straight-through estimator)
    state, step = build_state(name, **overrides), make_step()
    batch = torch.randn((8, cfg.in_chans, cfg.img_size, cfg.img_size),
                        generator=gen, device="cuda")
    # The step's own search: bf16 latents against the fp32 codebook parameter.
    # Kernel and plain version both round the codebook to the latents' dtype,
    # so the ids are held as in serving, on a codebook of the latents' scale
    # (the comparison's launches stay out of the path's totals).
    from tae_tpu_torch.ops.quantizer import nearest_code
    from tae_tpu_torch.utils.dtypes import Policy

    model = state.model
    with torch.no_grad():
        z = model.forward_encoder(batch, policy=Policy())
        zf = z.reshape(-1, cfg.vocab_size).float()
        model.codebook.copy_(codebook_from(zf, cfg.codebook_size, gen,
                                           replace=tag in VQ_STEP_RIVALS))
    check(z.dtype == torch.bfloat16 and model.codebook.dtype == torch.float32,
          f"{tag}: train step searches {z.dtype} latents in a "
          f"{model.codebook.dtype} codebook")
    differ = compare_ids(f"{tag} train step", z, model.codebook,
                         nearest_code(z, model.codebook),
                         nearest_code(z, model.codebook, backend="reference"),
                         VQ_ID_SHARE["bfloat16"])
    print(f"[{tag}] train step's search ({tuple(z.shape)} bf16 latents, fp32 "
          f"codebook rounded to bf16 in both versions): ids differ from "
          f"backend='reference' on a share {differ:.3g} of the rows")
    want = dict(train_launches(state.model.cfg), nearest_code=1)
    m, dt = counted_step(tag, step, state, batch, 0, want, totals)
    loss, grad = float(m["loss"]), state.model.codebook.grad
    check(loss == loss and abs(loss) != float("inf") and grad is not None
          and bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0,
          f"{tag}: train step loss {loss}, codebook gradient {grad}")
    print(f"[{tag}] train step B=8 with quantize=True: loss {loss:.6f}, "
          f"codebook gradient norm {float(grad.norm()):.3g} on "
          f"{int((grad.abs().sum(dim=1) > 0).sum())} codes, {dt * 1e3:.1f} ms")
    ran = {k: v for k, v in totals.items() if v}
    check(totals.get("nearest_code", 0) > 0, f"{tag}: K14 never launched")
    print(f"[{tag}] main path launches: {json.dumps(ran)}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_vq_f32() -> dict:
    """Path VQ_F32_PATH: vq_p16's model and codebook recipe in fp32. encode
    at every batch size, encode_discrete and decode_discrete at B = 8,
    each call's launches checked; latents, ids and reconstructions held
    against backend="reference". Returns the path's launch counts."""
    import gc

    import torch

    from tae_tpu_torch.tokenizer import Tokenizer

    tag = VQ_F32_PATH
    name, overrides = VQ_PATHS["vq_p16"]
    fns = wrappers()
    tok = Tokenizer.from_checkpoint(name, dtype=torch.float32, device="cuda",
                                    seed=0, **overrides)
    cfg, codebook = tok.model.cfg, tok.model.codebook
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = {b: torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                               dtype=torch.uint8, device="cuda", generator=gen)
              for b in BATCHES}
    z0 = tok.encode(images[BATCHES[-1]]).reshape(-1, cfg.vocab_size)
    check(z0.dtype == torch.float32 and codebook.dtype == torch.float32,
          f"{tag}: latents {z0.dtype}, codebook {codebook.dtype}")
    with torch.no_grad():
        codebook.copy_(codebook_from(z0, cfg.codebook_size, gen))
    per_call = expected_launches(cfg, None)
    check(per_call["encode"].get("fused_qkv_attention") == cfg.depth,
          f"{tag}: an encode runs {per_call['encode']}")
    print(f"[{tag}] {name} at depth {cfg.depth}+{cfg.decoder_depth} in fp32, "
          f"codebook {tuple(codebook.shape)} from seeded latents + noise; per "
          f"encode {json.dumps(per_call['encode'])}")

    totals = {}

    def request(fn, arg, want):
        return counted_request(tag, fns, totals, fn, arg, want)

    tok.encode(images[1])                                # warm-up request
    for f in fns.values():
        f.launches = 0
    ref = Tokenizer(model=tok.model, policy=tok.policy, backend="reference")
    n, v = cfg.num_patches, cfg.vocab_size
    latents = {}
    for b in BATCHES:
        runs = [request(tok.encode, images[b], per_call["encode"])
                for _ in range(GRAPH_WARM + REQUEST_REPS)][GRAPH_WARM:]
        z = latents[b] = runs[-1][0]
        check(tuple(z.shape) == (b, n, v) and z.dtype == torch.float32
              and bool(torch.isfinite(z).all()), f"{tag} B={b}: latents "
                                                 f"{tuple(z.shape)} {z.dtype}")
        err = rel_err(z, ref.encode(images[b]))
        print(f"[{tag}] encode B={b}: "
              f"{statistics.median(dt for _, dt in runs) * 1e3:.2f} ms/request; "
              f"latents rel_err {err:.3g} vs backend='reference' (tolerance "
              f"{F32_SLICE_REL_TOL})")
        check(err <= F32_SLICE_REL_TOL, f"{tag} B={b}: latents disagree with "
                                        "the plain versions")
    traced_replays(tag, tok, {"encode": images})
    b = BATCHES[1]
    enc_want = dict(per_call["encode"], nearest_code=1)
    ids, dt_enc = request(tok.encode_discrete, images[b], enc_want)
    check(tuple(ids.shape) == (b, n) and ids.dtype == torch.int64,
          f"{tag}: ids {tuple(ids.shape)} {ids.dtype}")
    rec, dt_dec = request(tok.decode_discrete, ids, per_call["decode"])
    check(tuple(rec.shape) == (b, 3, cfg.img_size, cfg.img_size)
          and rec.dtype == torch.float32 and bool(torch.isfinite(rec).all()),
          f"{tag}: reconstruction {tuple(rec.shape)} {rec.dtype}")
    # the comparisons: their launches stay out of the path's totals
    z = tok.encode(images[b])
    check(torch.equal(z, latents[b]), f"{tag}: two encodes of B={b} differ")
    check(torch.equal(tok.encode_discrete(z), ids),
          f"{tag}: ids of latents differ from ids of their images")
    differ = compare_ids(f"{tag} B={b}", z, codebook, ids,
                         ref.encode_discrete(z), VQ_ID_SHARE["float32"])
    err = rel_err(rec, ref.decode(codebook[ids]))
    check(err <= F32_SLICE_REL_TOL,
          f"{tag}: decode_discrete rel_err {err:.3g} vs backend='reference'")
    check(torch.equal(rec, tok.decode(codebook[ids])),
          f"{tag}: decode_discrete(ids) != decode(codebook[ids])")
    print(f"[{tag}] B={b}: encode_discrete {dt_enc * 1e3:.2f} ms, "
          f"decode_discrete {dt_dec * 1e3:.2f} ms; ids differ from "
          f"backend='reference' on a share {differ:.3g} of the rows (allowed "
          f"{VQ_ID_SHARE['float32']}); {int(ids.unique().numel())} codes used; "
          f"reconstruction rel_err {err:.3g}")
    ran = {k: c for k, c in totals.items() if c}
    check(totals.get("nearest_code", 0) > 0
          and totals.get("fused_qkv_attention", 0) > 0,
          f"{tag}: K2 or K14 never launched: {ran}")
    print(f"[{tag}] main path launches: {json.dumps(ran)}")
    del tok, ref
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# drivers: the user's entry points at full width
# ---------------------------------------------------------------------------

def driven(totals: dict | None, fn, *a, **kw):
    """fn(*a, **kw), a run through a user's entry point: every wrapper's
    count set to 0 just before, read just after a synchronize, and added to
    ``totals`` (None: a comparison's run, counted but kept out). Returns
    (output, {wrapper: launches} of the wrappers that launched)."""
    import torch

    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    got = {n: f.launches for n, f in fns.items() if f.launches}
    if totals is not None:
        for n, c in got.items():
            totals[n] = totals.get(n, 0) + c
    return out, got


def times(counts: dict, k: int) -> dict:
    return {name: k * n for name, n in counts.items() if n}


def float_launches(cfg) -> dict:
    """One forward of both halves of the float model with the exact softmax
    (calibration, evaluation): a LayerNorm kernel per norm, the attention
    entry of the route per block."""
    half = expected_launches(cfg, None)["encode"]
    return {name: 2 * n for name, n in half.items()}


def decoded_batches(data: str, n: int):
    """The first n batches of the encode driver's deterministic loader
    (val transform), inline: what the driver reads, decoded once more."""
    import itertools

    from tae_tpu_torch.cli.encode import make_encode_loader
    from tae_tpu_torch.models import create

    size = create(DRIVER_MODEL, device="meta").cfg.img_size
    loader = make_encode_loader(data, size, True, 0, DRIVER_BATCH, 0)
    return [x for x, _ in itertools.islice(loader, n)]


def drivers_calibration(tag: str, data: str, totals: dict) -> None:
    """Tokenizer.from_checkpoint(int8, equalize=0.5, calib_images=...)."""
    import torch

    from tae_tpu_torch.calibrate import ln_amax
    from tae_tpu_torch.tokenizer import Tokenizer

    batches = decoded_batches(data, CALIB_BATCHES)
    build = dict(dtype=torch.bfloat16, device="cuda", seed=0)
    tok = Tokenizer.from_checkpoint(DRIVER_MODEL, **build)
    cfg = tok.model.cfg
    # the dtype each LayerNorm and attention module is handed in the pass:
    # the counts are by wrapper, the fp32 forms are told apart by this
    from tae_tpu_torch.nn.vit import Attention, LayerNorm

    seen = set()

    def note(module, args):
        if args and isinstance(module, (Attention, LayerNorm)):
            seen.add((type(module).__name__, args[0].dtype))

    hook = torch.nn.modules.module.register_module_forward_pre_hook(note)
    try:
        tok_cal, got = driven(totals, Tokenizer.from_checkpoint, DRIVER_MODEL,
                              quantization="int8", equalize=0.5,
                              calib_images=batches, **build)
    finally:
        hook.remove()
    want = times(float_launches(cfg), CALIB_BATCHES)
    print(f"[{tag}] calibration: {CALIB_BATCHES} batches of {DRIVER_BATCH} "
          f"through Tokenizer.from_checkpoint(quantization='int8', "
          f"equalize=0.5, calib_images=...): launches {json.dumps(got)}, "
          f"expected {json.dumps(want)} (exact softmax); inputs of the "
          f"LayerNorm and attention modules {sorted(map(str, seen))}")
    check(got == want, f"{tag}: calibration launches {got}, expected {want}")
    check(seen == {("Attention", torch.float32), ("LayerNorm", torch.float32)},
          f"{tag}: the calibration pass ran {seen}, not K1 and K2 in fp32")
    stats = ln_amax(tok.model, batches)
    ref = ln_amax(tok.model, batches, backend="reference")
    check(stats.keys() == ref.keys() and len(stats) == 4 * cfg.depth + 2,
          f"{tag}: statistics keys {sorted(stats)}")
    worst = max(float(((stats[k] - ref[k]).abs() / ref[k].abs().clamp_min(
        1e-30)).max()) for k in ref)
    print(f"[{tag}] calibration statistics: {len(ref)} LayerNorm outputs, "
          f"worst channel {worst:.3g} relative to backend='reference' "
          f"(tolerance {CALIB_RTOL})")
    check(worst <= CALIB_RTOL, f"{tag}: calibration statistics differ")
    # the tokenizer's calibration is that pass: its weights equal those
    # built from the statistics just measured, bit for bit
    tok_act = Tokenizer.from_checkpoint(DRIVER_MODEL, quantization="int8",
                                        equalize=0.5, act_amax=stats, **build)
    a, b = tok_cal.model.state_dict(), tok_act.model.state_dict()
    check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
          f"{tag}: calib_images and act_amax= of the same statistics give "
          f"other weights")
    del tok_act
    tok_eq = Tokenizer.from_checkpoint(DRIVER_MODEL, quantization="int8",
                                       equalize=0.5, **build)
    x = torch.from_numpy(batches[0]).cuda()
    z = tok.encode(x)
    e_cal, e_eq = rel_err(tok_cal.encode(x), z), rel_err(tok_eq.encode(x), z)
    print(f"[{tag}] calibrated int8 latents rel_err {e_cal:.4g} vs the bf16 "
          f"tokenizer (tolerance {INT8_VS_BF16_TOL}); equalize=0.5 from the "
          f"LN affines alone {e_eq:.4g} (informative)")
    check(e_cal <= INT8_VS_BF16_TOL, f"{tag}: calibrated int8 too far from "
                                     "bf16")


def drivers_encode(tag: str, data: str, out: pathlib.Path, label: str,
                   totals: dict) -> None:
    """cli.encode.main in bf16, int8 (--equalize 0.5) and int4."""
    import numpy as np
    import torch

    from tae_tpu_torch.cli import encode
    from tae_tpu_torch.tokenizer import Tokenizer

    t = time.perf_counter()
    batches = decoded_batches(data, 4)
    decode_s = time.perf_counter() - t
    print(f"[{tag}] the val transform with PIL on one core, inline: "
          f"{4 * DRIVER_BATCH / decode_s:.1f} img/s (read, decode, resize, "
          f"crop, normalize, collate)")
    for mode, flags, quant, eq in (
            ("bf16", [], None, None),
            ("int8", ["--quantization", "int8", "--equalize", "0.5"], "int8",
             0.5),
            ("int4", ["--quantization", "int4"], "int4", None)):
        d = out / f"enc_{mode}"
        args = encode.get_args_parser().parse_args([
            "--model", DRIVER_MODEL, "--batch_size", str(DRIVER_BATCH),
            "--num_iters", "4", "--deterministic", "--data_path", data,
            # the single pass splits by shard: one shard, one worker
            "--num_workers", "1", "--output_dir", str(d),
            "--save_prefix", mode, *flags])
        stats, got = driven(totals, encode.main, args)
        tok = Tokenizer.from_checkpoint(DRIVER_MODEL, dtype=torch.bfloat16,
                                        device="cuda", seed=0,
                                        component="encoder",
                                        quantization=quant, equalize=eq)
        want = times(expected_launches(tok.model.cfg, quant)["encode"], 4)
        check(got == want, f"{tag} encode {mode}: launches {got}, expected "
                           f"{want}")
        index = json.loads((d / f"{mode}_index.json").read_text())
        check(index["num_samples"] == 4 * DRIVER_BATCH == stats["num_samples"],
              f"{tag} encode {mode}: index {index}")
        z = np.concatenate([np.load(d / s["path"])["latents"]
                            for s in index["shards"]])
        ref, walls = [], []
        for x in batches:
            x = torch.from_numpy(x).cuda()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref.append(tok.encode(x).to(torch.float16))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        ref = torch.cat(ref).cpu().numpy()
        same = z.shape == ref.shape and np.array_equal(z, ref)
        enc_ms = statistics.median(walls) * 1e3
        print(f"[{tag}] encode {mode}: {index['num_samples']} samples in "
              f"{len(index['shards'])} shard(s), latents {z.shape} "
              f"{z.dtype} bit-equal to Tokenizer.encode of the same batches: "
              f"{same}; launches per batch {json.dumps(times(got, 1 / 4))}; "
              f"the run {stats['seconds']:.2f} s, "
              f"{stats['images_per_sec']:.1f} img/s over its "
              f"{stats['num_samples']} images (a worker's start and one "
              f"worker's decoding included: not a throughput); "
              f"Tokenizer.encode alone {enc_ms:.2f} ms a batch of "
              f"{DRIVER_BATCH} ({label})")
        check(same, f"{tag} encode {mode}: latents differ from "
                    "Tokenizer.encode")
        del tok


def drivers_evaluate(tag: str, val: str, out: pathlib.Path, totals: dict
                     ) -> None:
    """cli.evaluate.main with the kernels and with --attn_backend
    reference; then, outside the driver, the same weights on the same
    images: the reconstructions with the kernels against the plain
    versions, and the driver's loss against the mean of the per-sample
    MSEs."""
    import numpy as np
    import torch

    from tae_tpu_torch.cli import _common, evaluate
    from tae_tpu_torch.utils.dtypes import Policy

    losses = {}
    for backend in ("kernel", "reference"):
        args = evaluate.get_args_parser().parse_args([
            "--model", DRIVER_MODEL, "--batch_size_per_gpu", str(DRIVER_BATCH),
            "--val_data_path", val, "--num_workers", str(DRIVER_WORKERS),
            "--output_dir", str(out), "--save_prefix", backend, "--display",
            *(["--attn_backend", "reference"] if backend == "reference"
              else [])])
        losses[backend], got = driven(totals if backend == "kernel" else None,
                                      evaluate.main, args)
        if backend == "kernel":
            # the driver's model, as it builds it
            model = _common.build_model(DRIVER_MODEL, device="cuda").eval()
            model.init_weights_(torch.Generator(device="cuda").manual_seed(
                args.seed))
            want = times(float_launches(model.cfg),
                         DRIVER_VAL // DRIVER_BATCH + 1)  # and the grid's
        else:
            want = {}
        check(got == want, f"{tag} evaluate ({backend}): launches {got}, "
                           f"expected {want}")
    grid = out / "kernel_sample_reconstructions.jpg"
    rel = abs(losses["kernel"] - losses["reference"]) / losses["reference"]
    policy, recon_err, per_rel, means, n = Policy(), 0.0, 0.0, [], 0
    with torch.no_grad():
        for x, _ in _common.imagefolder_val_loader(val, model.cfg.img_size,
                                                   DRIVER_BATCH):
            x = torch.from_numpy(x).cuda()
            target = model.patchify(x).float()
            pred, mse = {}, {}
            for backend in ("kernel", "reference"):
                b = None if backend == "kernel" else "reference"
                pred[backend] = model.forward_decoder(
                    model.forward_encoder(x, policy=policy, backend=b),
                    policy=policy, backend=b).float()
                mse[backend] = (pred[backend] - target).square().mean(
                    dim=(1, 2))
            recon_err = max(recon_err, rel_err(pred["kernel"],
                                               pred["reference"]))
            per_rel = max(per_rel, float(((mse["kernel"] - mse["reference"])
                                          / mse["reference"]).abs().max()))
            means.append(float(mse["kernel"].mean()))
            n += x.shape[0]
    own = float(np.mean(means))
    own_rel = abs(losses["kernel"] - own) / own
    print(f"[{tag}] evaluate: eval loss {losses['kernel']:.6f} vs "
          f"{losses['reference']:.6f} with --attn_backend reference, "
          f"relative {rel:.3g} (tolerance {EVAL_REF_RTOL}); outside the "
          f"driver, the same {n} images: reconstructions rel_err "
          f"{recon_err:.3g} vs backend='reference' (tolerance "
          f"{SLICE_REL_TOL}), per-sample MSE at most {per_rel:.3g} apart "
          f"(informative), the mean of batch means {own:.6f}, the driver's "
          f"{own_rel:.3g} from it (tolerance {EVAL_OWN_RTOL}); grid "
          f"{grid.name} written: {grid.is_file()}")
    check(n == DRIVER_VAL, f"{tag}: the val loader gave {n} images")
    check(rel <= EVAL_REF_RTOL and recon_err <= SLICE_REL_TOL
          and own_rel <= EVAL_OWN_RTOL and grid.is_file(),
          f"{tag}: evaluate loss, reconstructions or grid")
    del model


def drivers_train(tag: str, data: str, val: str, out: pathlib.Path,
                  label: str, totals: dict) -> None:
    """cli.train.main for DRIVER_TRAIN_ITS iterations, then again with
    --resume_auto; every step's launches counted and timed."""
    import torch

    from tae_tpu_torch.ckpt.io import checkpoint_step
    from tae_tpu_torch.cli import train
    from tae_tpu_torch.models import create

    cfg = create(DRIVER_MODEL, device="meta").cfg
    want = train_launches(cfg)
    real = train.make_train_step
    seen: list[tuple[int, float]] = []
    # the resumed run's parameters as its first step finds them
    first_params: dict = {}
    resuming = [False]

    fns = wrappers()

    def counted_make(*a, **kw):
        step = real(*a, **kw)

        def train_step(state_batch_it):
            return step(*state_batch_it)

        def counted(state, batch, it):
            if resuming[0] and not seen:
                first_params.update({k: v.detach().clone() for k, v in
                                     state.model.state_dict().items()})
            # the run's own count (driven) takes these launches; the step's
            # are checked here on their own
            out_, dt = counted_request(f"{tag} iteration {it}", fns, {},
                                       train_step, (state, batch, it), want)
            seen.append((it, dt))
            return out_

        return counted

    def run(extra):
        args = train.get_args_parser().parse_args([
            "--model", DRIVER_MODEL, "--batch_size_per_gpu", str(DRIVER_BATCH),
            "--num_its", str(DRIVER_TRAIN_ITS), "--save_freq",
            str(DRIVER_SAVE_FREQ), "--log_freq", "1", "--train_data_path",
            data, "--val_data_path", val, "--num_workers",
            str(DRIVER_WORKERS), "--output_dir", str(out), "--save_prefix",
            "tr", *extra])
        return driven(totals, train.main, args)[1]

    train.make_train_step = counted_make
    try:
        got = run([])
        first_run = list(seen)
        seen.clear()
        rows = [json.loads(x) for x in
                (out / "tr_log.txt").read_text().splitlines()]
        best, latest = out / "tr_checkpoint", out / "tr_checkpoint_latest"
        saved = torch.load(latest, map_location="cpu", weights_only=True)
        check([it for it, _ in first_run] == list(range(DRIVER_TRAIN_ITS)),
              f"{tag}: train iterations {first_run}")
        keys = {"train_loss", "train_lr", "train_grad_norm", "eval_loss",
                "iteration"}
        check(len(rows) == 1 and set(rows[0]) == keys
              and rows[0]["iteration"] == DRIVER_SAVE_FREQ,
              f"{tag}: JSONL rows {rows}")
        check(checkpoint_step(best) == checkpoint_step(latest)
              == DRIVER_SAVE_FREQ, f"{tag}: checkpoints "
              f"{checkpoint_step(best)} {checkpoint_step(latest)}")
        # the second run: --resume_auto from the newest checkpoint
        resuming[0] = True
        run(["--resume_auto"])
        resumed = [it for it, _ in seen]
        same = all(torch.equal(first_params[k].cpu(), v)
                   for k, v in saved["model"].items())
        check(resumed == list(range(DRIVER_SAVE_FREQ + 1, DRIVER_TRAIN_ITS))
              and same, f"{tag}: --resume_auto ran {resumed}, parameters "
                        f"equal to the checkpoint's: {same}")
    finally:
        train.make_train_step = real
    ms = statistics.median(dt for _, dt in first_run[1:]) * 1e3
    evals = {k: v for k, v in got.items() if k not in want}
    print(f"[{tag}] train: JSONL row at iteration {rows[0]['iteration']}: "
          f"{json.dumps(rows[0])}; {best.name} and {latest.name} at step "
          f"{DRIVER_SAVE_FREQ}; --resume_auto started at iteration "
          f"{resumed[0]} from the saved parameters; launches per step "
          f"{json.dumps(want)}, in the run's eval {json.dumps(evals)}")
    print(f"[{tag}] train: {ms:.2f} ms/step at B={DRIVER_BATCH} (median of "
          f"steps 1-{DRIVER_TRAIN_ITS - 1}, {DRIVER_BATCH / ms * 1e3:.1f} "
          f"img/s, {label})")


def drivers_graphs_off(tag: str, data: str, val: str,
                       root: pathlib.Path) -> None:
    """cli.train and cli.evaluate by default (from CUDA graphs) and with
    --cuda_graphs off, inline loading: cli.train GRAPH_DRIVER_ITS
    iterations at B = 64 with an eval every GRAPH_DRIVER_EVAL (its second
    replays the eval pass's graph, in the step's pool), the same step
    losses and JSONL rows (eval losses) and the peak memory of both;
    cli.evaluate at B = GRAPH_EVAL_BATCH (its batches replay one graph),
    the same loss."""
    from tae_tpu_torch.cli import evaluate, train

    graphs_off_against_default(f"{tag} train", train, [
        "--model", DRIVER_MODEL, "--batch_size_per_gpu", str(DRIVER_BATCH),
        "--num_its", str(GRAPH_DRIVER_ITS), "--save_freq",
        str(GRAPH_DRIVER_EVAL), "--log_freq", "1", "--train_data_path", data,
        "--val_data_path", val, "--num_workers", "0", "--output_dir",
        str(root / "train_off"), "--save_prefix", "off"], GRAPH_DRIVER_ITS,
        root / "train_off" / "off_log.txt")
    graphs_off_against_default(f"{tag} evaluate", evaluate, [
        "--model", DRIVER_MODEL, "--batch_size_per_gpu",
        str(GRAPH_EVAL_BATCH), "--val_data_path", val, "--num_workers", "0",
        "--output_dir", str(root / "evaluate_off"), "--save_prefix", "off"],
        0)


def phase_drivers() -> dict:
    """Path ``drivers``: calibration, and the encode, evaluate and train
    drivers on fake data at the p16 model's full width and depth. Returns
    the launch counts of the runs on the path."""
    import gc
    import tempfile

    import torch

    from tae_tpu_torch.data import native
    from tae_tpu_torch.data.fake import (make_fake_imagefolder,
                                         make_fake_wds_shard)

    tag, label, totals = "drivers", card_label(), {}
    try:
        import PIL
    except ImportError as e:
        raise SmokeFailure(f"{tag}: Pillow is missing ({e}); the fake data "
                           "and the PIL decoder need it") from e
    decoder = native.decoder_name()
    print(f"[{tag}] decoder: {decoder} (Pillow {PIL.__version__})")
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        shard = make_fake_wds_shard(root / "train-000000.tar",
                                    num_samples=DRIVER_SHARD, size=DRIVER_PX,
                                    seed=0)
        make_fake_imagefolder(root / "val", num_classes=2,
                              per_class=DRIVER_VAL // 2, size=DRIVER_PX, seed=1)
        data, val = str(shard), str(root / "val")
        print(f"[{tag}] {DRIVER_SHARD} JPEGs in a webdataset shard "
              f"({shard.stat().st_size / 1e6:.1f} MB) and {DRIVER_VAL} in an "
              f"ImageFolder, {DRIVER_PX} px, made in "
              f"{time.perf_counter() - t0:.1f} s")
        for part in (lambda: drivers_calibration(tag, data, totals),
                     lambda: drivers_encode(tag, data, root, label, totals),
                     lambda: drivers_evaluate(tag, val, root, totals),
                     lambda: drivers_train(tag, data, val, root / "train",
                                           label, totals),
                     lambda: drivers_graphs_off(tag, data, val, root)):
            t = time.perf_counter()
            part()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[{tag}] ({time.perf_counter() - t:.1f} s)")
    print(f"[{tag}] main path launches: {json.dumps(totals)}")
    return totals


# ---------------------------------------------------------------------------
# convergence: the structured corpus, cli.train in chunks, quant_accuracy
# ---------------------------------------------------------------------------

def uncounted(fn, *a, **kw):
    """fn(*a, **kw) with every wrapper's count put back after it: launches
    made to compare with the plain versions are not the path's."""
    import torch

    fns = wrappers()
    saved = {n: f.launches for n, f in fns.items()}
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    for n, f in fns.items():
        f.launches = saved[n]
    return out


def convergence_train(tag: str, root: pathlib.Path, cfg, totals: dict
                      ) -> dict:
    """Eval MSE of the seeded weights (cli.evaluate), then cli.train to
    CONV_ITS through the chunk loop; every train step's launches counted.
    Returns the JSONL rows."""
    import contextlib
    import io
    import math

    from tae_tpu_torch.cli import evaluate
    from tae_tpu_torch.scripts import convergence, convergence_report

    data = root / "data"
    args = evaluate.get_args_parser().parse_args([
        "--model", CONV_MODEL, "--batch_size_per_gpu", str(CONV_BATCH),
        "--val_data_path", str(data / "val"), "--num_workers", "0",
        "--output_dir", str(root / "eval0"), "--save_prefix", "e0"])
    eval0, got = driven(totals, evaluate.main, args)
    want = times(float_launches(cfg), CONV_VAL // CONV_BATCH)
    check(got == want, f"{tag} evaluate at iteration 0: launches {got}, "
                       f"expected {want}")
    argv = convergence.with_flags(
        convergence.train_argv(root, CONV_ITS + 1, CONV_CHUNK, CONV_SHARDS),
        accum_iter=1, num_workers=CONV_WORKERS)
    ends = convergence.chunk_ends(CONV_ITS + 1, CONV_CHUNK)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        records, got = driven(totals, convergence.run, argv, ends,
                              in_process=True)
    wall = time.perf_counter() - t
    text = buf.getvalue()
    log = root / "run.log"
    log.write_text(text)
    rows = convergence_report.parse_jsonl(str(root / "out" / "conv_log.txt"))
    points = convergence_report.parse_stdout(str(log))
    for line in text.splitlines():
        if line.startswith("[convergence]"):
            print(line)
        elif line.startswith(("it ", "Auto-resumed", "Current eval loss",
                              "Input pipeline", "decoder:", "cuda graphs:")):
            print(f"[{tag}] {line}")
    # per step: the training entries of a remat step; per eval pass and
    # grid: one float forward a batch (a val pass of one padded batch)
    step = train_launches(cfg, remat=True)
    evals = CONV_ITS // CONV_CHUNK
    want = summed(times(step, CONV_ITS + 1), times(float_launches(cfg),
                                                   2 * evals))
    check(got == want, f"{tag} train: launches {got}, expected {want}")
    check([r["end"] for r in records] == ends
          and all(r["attempts"] == 1 for r in records),
          f"{tag}: chunks {records}")
    logged = [p[0] for p in points]
    check(logged == [it for it in range(CONV_ITS + 1) if it % 50 == 0],
          f"{tag}: logged iterations {logged}")
    check(all(math.isfinite(v) for p in points for v in p[1:])
          and all(math.isfinite(r[k]) for r in rows
                  for k in ("train_loss", "eval_loss")),
          f"{tag}: a non-finite loss in {points} / {rows}")
    check([r["iteration"] for r in rows] == list(
        range(CONV_CHUNK, CONV_ITS + 1, CONV_CHUNK)), f"{tag}: rows {rows}")
    last = rows[-1]["eval_loss"]
    print(f"[{tag}] eval MSE: {eval0:.6f} at iteration 0 (cli.evaluate on "
          f"the seeded weights), "
          + ", ".join(f"{r['eval_loss']:.6f} at {r['iteration']}"
                      for r in rows)
          + f"; at {CONV_ITS} {last / eval0:.4f} of iteration 0's (at most "
          f"{CONV_EVAL_DROP}); train loss logged at {logged}: "
          + ", ".join(f"{w:.4f}" for _, w, _ in points)
          + f"; chunks " + ", ".join(f"to {r['end'] - 1}: {r['seconds']:.1f} s"
                                     for r in records)
          + f" ({wall:.1f} s in all)")
    check(last <= CONV_EVAL_DROP * eval0,
          f"{tag}: eval MSE {last:.6f} at {CONV_ITS} against {eval0:.6f} at 0")
    return rows


def convergence_quant(tag: str, root: pathlib.Path, cfg, totals: dict
                      ) -> dict:
    """quant_accuracy's six modes on the trained checkpoint (the JAX
    script's forward, the exact softmax); each quantized tokenizer's encode
    and decode held against backend="reference" on the trained weights, and
    the bf16 tokenizer's serving MSE against quant_accuracy's bf16 row."""
    import torch

    from tae_tpu_torch.ckpt.io import checkpoint_step
    from tae_tpu_torch.scripts import quant_accuracy
    from tae_tpu_torch.tokenizer import Tokenizer

    ckpt = root / "out" / "conv_checkpoint_latest"
    check(checkpoint_step(ckpt) == CONV_ITS,
          f"{tag}: checkpoint at {checkpoint_step(ckpt)}")
    batches = quant_accuracy.load_batches(
        str(root / "data" / "val"), cfg.img_size, CONV_QUANT_BATCH,
        CONV_QUANT_BATCHES + CONV_CALIB_BATCHES)
    evals, calib = (batches[:CONV_QUANT_BATCHES],
                    batches[CONV_QUANT_BATCHES:])
    xs = [torch.from_numpy(b).cuda() for b in evals]
    x = xs[0]
    tol = slice_tol(4e-2, cfg)
    held, serving = {}, {}

    def against_reference(name, tok):
        if name == "bf16":
            serving["mse"] = sum(float(torch.mean(torch.square(
                tok.decode(tok.encode(b)).float() - b))) for b in xs) / len(xs)
            return
        ref = Tokenizer(model=tok.model, policy=tok.policy,
                        backend="reference", cuda_graphs=False)
        z = tok.encode(x)
        ez = rel_err(z, ref.encode(x))
        ex = rel_err(tok.decode(z), ref.decode(z))
        held[name] = (ez, ex)
        check(ez <= tol and ex <= tol,
              f"{tag} {name}: latents {ez:.3g}, decode {ex:.3g} against "
              f"backend='reference' (tolerance {tol:.3g})")

    results, got = driven(
        totals, quant_accuracy.evaluate_modes, CONV_MODEL, str(ckpt), evals,
        calib, list(quant_accuracy.MODES), "cuda",
        each=lambda name, tok: uncounted(against_reference, name, tok))
    want = times(float_launches(cfg), CONV_CALIB_BATCHES)
    for name, kw in quant_accuracy.MODES.items():
        # the exact forward: no int8-output attention
        per = expected_launches(cfg, kw.get("quantization"), attn_q8=False)
        want = summed(want, times(per["encode"], CONV_QUANT_BATCHES),
                      times(per["decode"], CONV_QUANT_BATCHES))
    check(got == want, f"{tag} quant_accuracy: launches {got}, expected "
                       f"{want}")
    print(f"[{tag}] quant_accuracy on {ckpt.name} (step {CONV_ITS}), "
          f"{CONV_QUANT_BATCHES} x {CONV_QUANT_BATCH} val images, calibration on "
          f"{CONV_CALIB_BATCHES} more batches:")
    for line in quant_accuracy.table(results).splitlines():
        print(f"[{tag}] {line}")
    for name, (ez, ex) in held.items():
        print(f"[{tag}] {name} against backend='reference' on the trained "
              f"weights: latents rel_err {ez:.3g}, decode rel_err {ex:.3g} "
              f"(tolerance {tol:.3g})")
    base = results["bf16"]["mse"]
    ratio = serving["mse"] / base
    print(f"[{tag}] bf16 Tokenizer encode / decode (serving softmax) on the "
          f"trained weights: MSE {serving['mse']:.6f}, {ratio:.4f} x "
          f"quant_accuracy's bf16 row {base:.6f} (the exact softmax; at most "
          f"{CONV_SERVING_MSE_RATIO})")
    check(ratio <= CONV_SERVING_MSE_RATIO,
          f"{tag}: the bf16 Tokenizer's MSE {serving['mse']:.6f} against "
          f"{base:.6f} through the exact forward")
    for name, r in results.items():
        if name == "bf16":
            continue
        check(r["rel_err"] <= CONV_QUANT_REL_ERR
              and r["mse"] <= CONV_QUANT_MSE_RATIO * base,
              f"{tag} {name}: latent rel err {r['rel_err']:.4g}, MSE "
              f"{r['mse']:.6f} against bf16's {base:.6f}")
    check(set(held) == set(results) - {"bf16"},
          f"{tag}: held against the plain versions: {sorted(held)}")
    return results


def phase_convergence() -> dict:
    """Path ``convergence``: the convergence run's corpus, model and driver
    cut to CONV_ITS iterations of B = CONV_BATCH, then quant_accuracy on
    what it trained. Returns the launch counts of the run."""
    import gc
    import tempfile

    import torch

    from tae_tpu_torch.models import create
    from tae_tpu_torch.scripts import convergence

    tag, totals = "convergence", {}
    cfg = create(CONV_MODEL, device="meta").cfg
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        convergence.fixture(root, CONV_SHARDS, CONV_SHARD_IMAGES, CONV_PX,
                            CONV_VAL, workers=CONV_SHARDS + 1)
        print(f"[{tag}] corpus: {CONV_SHARDS} shards of {CONV_SHARD_IMAGES} "
              f"structured images and {CONV_VAL} val images, {CONV_PX} px, "
              f"in {time.perf_counter() - t:.1f} s")
        for part in (convergence_train, convergence_quant):
            t = time.perf_counter()
            part(tag, root, cfg, totals)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[{tag}] ({time.perf_counter() - t:.1f} s)")
    print(f"[{tag}] main path launches: {json.dumps(totals)}")
    return totals


# ---------------------------------------------------------------------------
# downstream: the recognition and segmentation trunks on the frozen encoder
# ---------------------------------------------------------------------------

def phase_downstream_kernels(label: str) -> dict:
    """The downstream trunks' shapes, which no other path runs: K2 (exact
    and LSE forms) and K10 at (64, 256, 2304) with 12 heads of 64; K1, its
    stats form and K11 at width 768 with rec19k's rows (64 x 256) and
    seg_p16's (8 x 256), K1's and K11's plans held against the library's.
    Each against its plain version, timed beside its bound and library
    call. Returns case records to add to the kernel phases' lists (tuples
    for K1 and K2, as phase_kernels keeps them; dicts for the training
    forms)."""
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.flash_attention import (
        fused_qkv_attention, fused_qkv_attention_backward_reference,
        fused_qkv_attention_bwd, fused_qkv_attention_fwd_lse,
        fused_qkv_attention_lse_reference, fused_qkv_attention_reference)
    from tae_tpu_torch.ops.cuda.layernorm import (
        bwd_plan, bwd_plan_of_library, fused_layer_norm, fused_layer_norm_bwd,
        fused_layer_norm_fwd_stats, fwd_plan, fwd_plan_of_library)
    from tae_tpu_torch.ops.layernorm import (layer_norm_backward_reference,
                                             layer_norm_reference,
                                             layer_norm_stats_reference)

    gen = torch.Generator(device="cuda").manual_seed(2468)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    res = {name: [] for name in (
        "fused_layer_norm", "fused_qkv_attention", "fused_layer_norm_fwd_stats",
        "fused_layer_norm_bwd", "fused_qkv_attention_fwd_lse",
        "fused_qkv_attention_bwd")}

    def randn(shape, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale + shift).to(bf16)

    def record(kernel, case, err, ms, plain, bnd, lib, lib_name, **extra):
        res[kernel].append(dict(case=case, max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=bnd[0],
                                bound_by=bnd[1], library_ms=lib, **extra))
        more = "".join(f", {k} {v:.4f} ms" for k, v in extra.items())
        print(f"[kernels] {case}: max_abs_err {err:.3g}; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"{lib_name} {lib:.4f} ms{more} ({label})")

    d = 768
    for rows in (REC_BATCH * 256, SEG_BATCH * 256):
        for plan, lib_plan, name in ((fwd_plan, fwd_plan_of_library, "K1"),
                                     (bwd_plan, bwd_plan_of_library, "K11")):
            check(lib_plan(rows, d) == plan(rows, d),
                  f"{name}'s plan at ({rows}, {d}): library "
                  f"{lib_plan(rows, d)}, ops/cuda/layernorm {plan(rows, d)}")
        x = randn((rows, d), 3.0, 1.0)
        w, b = randn((d,), 1.0, 1.0), randn((d,))
        dy = randn((rows, d))
        y = fused_layer_norm(x, w, b, 1e-6)
        err = compare(f"K1 ({rows}, {d})", y,
                      layer_norm_reference(x, w, b, 1e-6), **tol)
        ms = time_ms(lambda: fused_layer_norm(x, w, b, 1e-6))
        plain = time_ms(lambda: layer_norm_reference(x, w, b, 1e-6))
        lib = time_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-6))
        bnd = bound(nbytes(x, w, b, y), 0.0, "bf16")
        res["fused_layer_norm"].append((bf16, err, ms, plain, bnd, lib))
        print(f"[kernels] K1 layer_norm ({rows}, {d}) bf16 (plan "
              f"{fwd_plan(rows, d)}): max_abs_err {err:.3g}; kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"F.layer_norm {lib:.4f} ms ({label})")

        y, mean, rstd = fused_layer_norm_fwd_stats(x, w, b, 1e-6)
        y_ref, mean_ref, rstd_ref = layer_norm_stats_reference(x, w, b, 1e-6)
        case = f"K1 layer_norm with stats ({rows}, {d}) bfloat16"
        err = compare(case, y, y_ref, **tol)
        compare(case + " mean", mean, mean_ref, **STATS_TOL)
        compare(case + " rstd", rstd, rstd_ref, **STATS_TOL)
        record("fused_layer_norm_fwd_stats", case, err,
               time_ms(lambda: fused_layer_norm_fwd_stats(x, w, b, 1e-6)),
               time_ms(lambda: layer_norm_stats_reference(x, w, b, 1e-6)),
               bound(nbytes(x, w, b, y, mean, rstd), 0.0, "bf16"),
               time_ms(lambda: torch.ops.aten.native_layer_norm(
                   x, [d], w, b, 1e-6)), "aten.native_layer_norm")

        dx, dw, db = fused_layer_norm_bwd(x, w, mean, rstd, dy)
        dx_ref, dw_ref, db_ref = layer_norm_backward_reference(x, w, mean,
                                                               rstd, dy)
        case = f"K11 layer_norm backward ({rows}, {d}) bfloat16"
        sum_tol = dict(atol=tol["atol"] * max(1.0, rows ** 0.5 / 8),
                       rtol=tol["rtol"])
        err = max(compare(case + " dx", dx, dx_ref, **tol),
                  compare(case + " dw", dw, dw_ref, **sum_tol),
                  compare(case + " db", db, db_ref, **sum_tol))
        again = fused_layer_norm_bwd(x, w, mean, rstd, dy)
        check(all(torch.equal(a, b_) for a, b_ in zip(again, (dx, dw, db))),
              f"{case}: two runs differ in their bits")
        _, lm, lr_ = torch.ops.aten.native_layer_norm(x, [d], w, b, 1e-6)
        record("fused_layer_norm_bwd", case, err,
               time_ms(lambda: fused_layer_norm_bwd(x, w, mean, rstd, dy)),
               time_ms(lambda: layer_norm_backward_reference(x, w, mean, rstd,
                                                             dy)),
               bound(nbytes(x, w, mean, rstd, dy, dx, dw, db), 0.0, "bf16"),
               time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                   dy, x, [d], lm, lr_, w, b, [True, True, True])),
               "F.layer_norm's backward")

    batch, n, h, dh = REC_BATCH, 256, 12, 64
    c = h * dh
    qkv, do = randn((batch, n, 3 * c)), randn((batch, n, c))
    shape = f"{tuple(qkv.shape)} h={h} dh={dh} bfloat16"
    r = qkv.view(batch, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(r[0], r[1], r[2]))
    flops = 4.0 * batch * h * n * n * dh
    y = fused_qkv_attention(qkv, h, serving=False)
    err = compare(f"K2 {shape} exact", y,
                  fused_qkv_attention_reference(qkv, h, serving=False), **tol)
    ms = time_ms(lambda: fused_qkv_attention(qkv, h, serving=False))
    plain = time_ms(lambda: fused_qkv_attention_reference(qkv, h,
                                                          serving=False))
    bnd = bound(nbytes(qkv, y), flops, "bf16")
    res["fused_qkv_attention"].append((bf16, err, ms, plain, n, False, bnd,
                                       sdpa))
    print(f"[kernels] K2 attention {shape} exact: max_abs_err {err:.3g}; "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]}), SDPA {sdpa:.4f} ms ({label})")

    o, lse = fused_qkv_attention_fwd_lse(qkv, h)
    o_ref, lse_ref = fused_qkv_attention_lse_reference(qkv, h)
    case = f"K2 attention with LSE {shape}"
    err = compare(case, o, o_ref, **tol)
    compare(case + " lse", lse, lse_ref, **STATS_TOL)
    record("fused_qkv_attention_fwd_lse", case, err,
           time_ms(lambda: fused_qkv_attention_fwd_lse(qkv, h)),
           time_ms(lambda: fused_qkv_attention_lse_reference(qkv, h)),
           bound(nbytes(qkv, o, lse), flops, "bf16"), sdpa, "SDPA")

    dqkv = fused_qkv_attention_bwd(qkv, o, lse, do, h)
    case = f"K10 attention backward {shape}"
    err = compare(case, dqkv, fused_qkv_attention_backward_reference(
        qkv, o, lse, do, h), **tol)
    check(torch.equal(dqkv, fused_qkv_attention_bwd(qkv, o, lse, do, h)),
          f"{case}: two runs differ in their bits")
    q, k, v = (t.detach().requires_grad_() for t in r)
    so = F.scaled_dot_product_attention(q, k, v)
    sdo = do.view(batch, n, h, dh).transpose(1, 2)
    lib = time_ms_events(lambda: torch.autograd.grad(so, (q, k, v), sdo,
                                                     retain_graph=True))
    events = time_ms_events(lambda: fused_qkv_attention_bwd(qkv, o, lse, do, h))
    record("fused_qkv_attention_bwd", case, err,
           time_ms(lambda: fused_qkv_attention_bwd(qkv, o, lse, do, h)),
           time_ms(lambda: fused_qkv_attention_backward_reference(
               qkv, o, lse, do, h)),
           bound(nbytes(qkv, o, lse, do, dqkv), 2.5 * flops, "bf16"), lib,
           "SDPA's backward (between events)", events_ms=events)
    return res


def downstream_encoder(quantization):
    """The downstream drivers' frozen encoder stage, built as they build it
    (cli/_common.frozen_encoder): REC_ENCODER from seed 1, bf16, pruned to
    its encoder half, int8 serving layout or not."""
    import types

    import torch

    from tae_tpu_torch.cli._common import frozen_encoder as build

    return build(types.SimpleNamespace(
        encoder=REC_ENCODER, encoder_args="", encoder_ckpt="", seed=0,
        encoder_quantization=quantization, encoder_equalize=0.0),
        torch.device("cuda"))


def encoder_launches(encoder, quantization) -> dict:
    """One forward_encoder of the frozen stage with the exact softmax, as
    the drivers call it (serving=False): the bf16 tokenizer's encode
    launches, or the int8 ones with the attention in bf16 (K2) and a plain
    quantize ahead of proj, as ``attn_q8=False`` gives them."""
    return expected_launches(encoder.cfg, quantization, attn_q8=False)["encode"]


def trunk_launches(cfg, remat: bool = False) -> dict:
    """Each kernel's launches in one train step of a downstream trunk, as
    the code implies them: a training LayerNorm forward and a LayerNorm
    backward per norm (two a block, the final one, and the segmenter's
    auxiliary one), a training attention forward and backward per block;
    ``remat`` runs every block's forward once more."""
    from tae_tpu_torch.ops.attention import attention_route

    blocks = cfg.decoder_depth
    norms = 2 * blocks + 1 + int(hasattr(cfg, "aux_depth"))
    again = blocks if remat else 0
    want = {"fused_layer_norm_fwd_stats": norms + 2 * again,
            "fused_layer_norm_bwd": norms}
    if attention_route(cfg.num_patches, False, False)[0] == "wide":
        want["fused_qkv_attention_wide"] = blocks + again
    else:
        want["fused_qkv_attention_fwd_lse"] = blocks + again
        want["fused_qkv_attention_bwd"] = blocks
    return want


def trunk_forward_launches(cfg) -> dict:
    """One forward of a downstream trunk without a gradient (an eval or a
    prediction): a LayerNorm kernel per norm, the exact attention per
    block."""
    want = trunk_launches(cfg)
    return {"fused_layer_norm": want["fused_layer_norm_bwd"],
            "fused_qkv_attention": cfg.decoder_depth}


def summed(*counts: dict) -> dict:
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def downstream_step(encoder, model_loss, schedule, weight_decay: float,
                    backend=None, remat: bool = False, moment_dtype=None,
                    cuda_graphs=None):
    """A downstream driver's train step: the frozen encoder under no_grad
    (the JAX drivers' stop_gradient) feeding the trainable trunk, bf16
    compute, AdamW (``moment_dtype`` as ``adamw`` takes it), from CUDA
    graphs as ``make_train_step(cuda_graphs=)`` says."""
    import torch

    from tae_tpu_torch.train import adamw, make_train_step
    from tae_tpu_torch.utils.dtypes import Policy

    enc_policy = Policy(param_dtype=torch.bfloat16)

    def loss_fn(m, batch):
        x, y = batch
        with torch.no_grad():
            z = encoder.forward_encoder(x, policy=enc_policy, backend=backend)
        return model_loss(m(z, backend=backend, remat=remat), y), {}

    return make_train_step(loss_fn, adamw(weight_decay=weight_decay,
                                          moment_dtype=moment_dtype),
                           schedule, cuda_graphs=cuda_graphs)


def downstream_state(name: str, weight_decay: float, **kw):
    import torch

    from tae_tpu_torch import models
    from tae_tpu_torch.train import TrainState, adamw

    model = models.create(name, device="cuda", trainable=True, **kw)
    model.init_weights_(torch.Generator(device="cuda").manual_seed(1))
    return TrainState.create(model, adamw(weight_decay=weight_decay))


def trunk_against_reference(tag: str, build, make, state, batch,
                            want: dict) -> None:
    """One step with the kernels and one with the plain versions on a copy
    of the same weights (``build()`` makes the copy's state, ``make(backend)``
    the step): the losses and every gradient."""
    import gc

    import torch

    ref = build()
    ref.model.load_state_dict(state.model.state_dict())
    m, _ = counted_step(tag, make(None), state, batch, 0, want, {})
    m_ref, _ = counted_step(tag, make("reference"), ref, batch, 0, {}, {})
    loss, loss_ref = float(m["loss"]), float(m_ref["loss"])
    print(f"[{tag}] B={batch[0].shape[0]} step: loss {loss:.6f} vs "
          f"{loss_ref:.6f} with backend='reference' (rtol {TRAIN_LOSS_RTOL}); "
          f"grad_norm {float(m['grad_norm']):.4f} vs "
          f"{float(m_ref['grad_norm']):.4f}")
    check(abs(loss - loss_ref) <= TRAIN_LOSS_RTOL * abs(loss_ref),
          f"{tag}: losses differ")
    compare_gradients(tag, state.model, ref.model, TRAIN_GRAD_REL_TOL)
    del ref, m_ref
    gc.collect()
    torch.cuda.empty_cache()


def timed_steps(tag: str, make, state, batch, steps: int, want: dict,
                label: str, falling: bool) -> dict:
    """The main path of a downstream trunk: ``steps`` steps on one batch,
    every count 0 before the first and each step's launches held to
    ``want``; finite losses, and with ``falling`` the last below the first;
    ms / step (the median after the first), img/s and the peak memory of
    the steps. Returns the launch counts of the steps."""
    import torch

    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step, totals, losses, walls = make(None), {}, [], []
    for it in range(1, steps + 1):
        m, dt = counted_step(tag, step, state, batch, it, want, totals)
        losses.append(float(m["loss"]))
        walls.append(dt)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses)
          and (losses[-1] < losses[0] or not falling),
          f"{tag}: losses {losses} are not finite"
          + (" and falling" if falling else ""))
    on_path = [k for k, v in want.items() if v]
    check(all(totals.get(k, 0) > 0 for k in on_path),
          f"{tag}: a kernel of the path never launched: {totals}")
    b = batch[0].shape[0]
    ms = statistics.median(walls[1:]) * 1e3
    print(f"[{tag}] {steps} steps at B={b}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}")
    print(f"[{tag}] {ms:.2f} ms/step (runs {min(walls[1:]) * 1e3:.2f}-"
          f"{max(walls[1:]) * 1e3:.2f}), {b / ms * 1e3:.1f} img/s at B={b}, "
          f"peak memory {peak:.2f} GiB ({label})")
    print(f"[{tag}] main path launches: {json.dumps(totals)} (per step: "
          f"{json.dumps(want)})")
    return totals


def phase_rec19k(label: str) -> dict:
    """Path ``rec19k``: the JAX bench's train_rec19k_int8enc_mb64 recipe at
    full width (see REC_MODEL): one step at B = 8 against
    backend="reference" on the same weights, then REC_STEPS steps at
    REC_BATCH with each step's launches checked. Returns the launch counts
    of the steps."""
    import gc

    import torch

    from tae_tpu_torch.train import step_lr
    from tae_tpu_torch.train.losses import cross_entropy

    tag = "rec19k"
    encoder = downstream_encoder("int8")

    def build():
        return downstream_state(REC_MODEL, 0.0, num_classes=REC_CLASSES)

    def make(backend):
        return downstream_step(encoder, cross_entropy,
                               step_lr(1e-4, 1e-5, 500_000), 0.0, backend,
                               remat=True)

    state = build()
    cfg = state.model.cfg
    want = summed(encoder_launches(encoder, "int8"),
                  trunk_launches(cfg, remat=True))
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[{tag}] {REC_MODEL}: {n_params} fp32 parameters ({cfg.decoder_depth} "
          f"blocks of {cfg.decoder_embed_dim}, {cfg.decoder_num_heads} heads, "
          f"{cfg.num_classes} classes), bf16 compute, remat=True, AdamW "
          f"(weight decay 0); frozen {REC_ENCODER} encoder, int8, exact "
          f"softmax; launches per step {json.dumps(want)}")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def batch(b):
        return (torch.randn((b, 3, 256, 256), generator=gen, device="cuda"),
                torch.arange(b, device="cuda") * 2399 % REC_CLASSES)

    trunk_against_reference(tag, build, make, state, batch(8), want)
    totals = timed_steps(tag, make, state, batch(REC_BATCH), REC_STEPS, want,
                         label, falling=True)
    del state, encoder
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_seg_p16(label: str) -> dict:
    """Path ``seg_p16``: the segmenter at full width on the frozen bf16
    encoder, the driver's recipe: its outputs, ``out`` and ``aux`` from the
    same images, and one step, against backend="reference"; a prediction
    with its launches checked; SEG_STEPS steps with each step's launches
    checked. Returns the launch counts of the steps."""
    import gc

    import torch

    from tae_tpu_torch.cli.train_segmentation import criterion
    from tae_tpu_torch.train import epoch_step_lr
    from tae_tpu_torch.utils.dtypes import Policy

    tag = "seg_p16"
    encoder = downstream_encoder(None)

    def build():
        return downstream_state(SEG_MODEL, 1e-4, num_classes=SEG_CLASSES)

    def make(backend):
        return downstream_step(encoder, criterion, epoch_step_lr(0.01, 90, 0.1),
                               1e-4, backend)

    state = build()
    model, cfg = state.model, state.model.cfg
    enc_want = encoder_launches(encoder, None)
    want = summed(enc_want, trunk_launches(cfg))
    print(f"[{tag}] {SEG_MODEL}: {sum(p.numel() for p in model.parameters())} "
          f"fp32 parameters ({cfg.decoder_depth} blocks, the auxiliary head "
          f"after {cfg.aux_depth}, {cfg.num_classes} classes, patch "
          f"{cfg.patch_size}), bf16 compute, AdamW (weight decay 1e-4, lr "
          f"0.01); frozen bf16 {REC_ENCODER} encoder; launches per step "
          f"{json.dumps(want)}")
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((SEG_BATCH, 3, 256, 256), generator=gen, device="cuda")
    y = torch.randint(0, SEG_CLASSES, (SEG_BATCH, 256, 256), generator=gen,
                      device="cuda")
    y[torch.rand(y.shape, generator=gen, device="cuda") < 0.05] = 255

    fns, policy = wrappers(), Policy()
    enc_policy = Policy(param_dtype=torch.bfloat16)

    def predict(backend):
        with torch.no_grad():
            z = encoder.forward_encoder(x, policy=enc_policy, backend=backend)
            return model(z, policy=policy, backend=backend)

    out, _ = counted_request(tag, fns, {}, lambda _: predict(None), None,
                             summed(enc_want, trunk_forward_launches(cfg)))
    ref = predict("reference")
    tol = slice_tol(SLICE_REL_TOL, encoder.cfg)
    errs = {k: rel_err(out[k], ref[k]) for k in ("out", "aux")}
    print(f"[{tag}] forward at B={SEG_BATCH}: out {tuple(out['out'].shape)} "
          f"{out['out'].dtype}, rel_err vs backend='reference' out "
          f"{errs['out']:.4g}, aux {errs['aux']:.4g} (tolerance {tol}); "
          f"launches {json.dumps(summed(enc_want, trunk_forward_launches(cfg)))}")
    check(all(bool(torch.isfinite(out[k]).all()) for k in out)
          and out["out"].shape == out["aux"].shape
          == (SEG_BATCH, SEG_CLASSES, 256, 256),
          f"{tag}: outputs not finite or of another shape")
    check(max(errs.values()) <= tol, f"{tag}: outputs differ from the plain "
                                     f"versions' ({errs})")
    del out, ref
    trunk_against_reference(tag, build, make, state, (x, y), want)
    # lr 0.01 (the driver's default) need not lower the loss on one batch
    totals = timed_steps(tag, make, state, (x, y), SEG_STEPS, want, label,
                         falling=False)
    del state, model, encoder
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def steps_counted(module, tag: str, want: dict, seen: list):
    """Wrap a driver's ``make_train_step`` so that each step's launches are
    held to ``want`` and its wall time (host clock to a synchronize) kept in
    ``seen`` as (iteration, seconds). Returns the original, to put back."""
    real = module.make_train_step
    fns = wrappers()

    def counted_make(*a, **kw):
        step = real(*a, **kw)

        def train_step(args):
            return step(*args)

        def counted(state, batch, it):
            out, dt = counted_request(f"{tag} step {len(seen)}", fns, {},
                                      train_step, (state, batch, it), want)
            seen.append((it, dt))
            return out

        return counted

    module.make_train_step = counted_make
    return real


def run_driver(module, tag: str, argv: list, want: dict, totals: dict | None):
    """``module.main`` on ``argv`` through ``driven`` (counted from 0, added
    to ``totals``), each train step's launches held to ``want``. Returns
    (the run's launch counts, [(iteration, seconds)] of its steps)."""
    seen: list = []
    real = steps_counted(module, tag, want, seen)
    try:
        _, got = driven(totals, module.main,
                        module.get_args_parser().parse_args(argv))
    finally:
        module.make_train_step = real
    return got, seen


def ds_rows(path: pathlib.Path) -> list[dict]:
    return [json.loads(x) for x in path.read_text().splitlines()]


def phase_downstream_drivers(label: str) -> dict:
    """Path ``downstream``: the three downstream drivers through their
    ``main`` on fake data made by ``data/fake`` (see DS_SHARD), each step's
    launches checked, and each run's total: train_recognition_in19k with
    the int8 encoder and the 19167-class head; train_recognition_in1k from
    its checkpoint with the head swapped to 3 classes, one epoch, against
    --attn_backend reference; train_segmentation one epoch against
    --attn_backend reference, then --resume for the next, and the first
    epoch's checkpoint run outside the driver through the kernels and the
    plain versions. Returns the launch counts of the kernel runs."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from tae_tpu_torch import models
    from tae_tpu_torch.ckpt.io import checkpoint_step, load_checkpoint, load_params
    from tae_tpu_torch.cli import train_recognition_in1k as r1k
    from tae_tpu_torch.cli import train_recognition_in19k as r19k
    from tae_tpu_torch.cli import train_segmentation as seg
    from tae_tpu_torch.data import mask_native, native
    from tae_tpu_torch.data.coco_seg import load_dataset
    from tae_tpu_torch.data.fake import (make_fake_imagefolder,
                                         make_fake_wds_shard,
                                         make_structured_coco)
    from tae_tpu_torch.data.seg_transforms import SegEvalTransform
    from tae_tpu_torch.utils.dtypes import Policy

    tag, totals = "downstream", {}
    enc_cfg = models.create(REC_ENCODER, device="meta").cfg
    rec_cfg = models.create(REC_MODEL, num_classes=REC_CLASSES,
                            device="meta").cfg
    seg_cfg = models.create(SEG_MODEL, device="meta").cfg
    enc_bf16 = expected_launches(enc_cfg, None, attn_q8=False)["encode"]
    enc_int8 = expected_launches(enc_cfg, "int8", attn_q8=False)["encode"]
    print(f"[{tag}] decoder: {native.decoder_name()}; native mask decoders "
          f"(native/maskapi.cpp) built: {mask_native.available()}")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t = time.perf_counter()
        shard = make_fake_wds_shard(root / "in19k-000000.tar",
                                    num_samples=DS_SHARD, size=DRIVER_PX,
                                    num_classes=REC_CLASSES, seed=10)
        make_fake_imagefolder(root / "train", num_classes=DS_CLASSES,
                              per_class=DS_TRAIN_PER_CLASS, size=DRIVER_PX,
                              seed=11)
        make_fake_imagefolder(root / "val", num_classes=DS_CLASSES,
                              per_class=DS_VAL_PER_CLASS, size=DRIVER_PX,
                              seed=12)
        coco = make_structured_coco(root / "coco", n_train=DS_COCO_TRAIN,
                                    n_val=DS_COCO_VAL, size=DRIVER_PX, seed=13)
        print(f"[{tag}] fake data: a {DS_SHARD}-JPEG in19k shard, in1k "
              f"ImageFolders of {DS_CLASSES * DS_TRAIN_PER_CLASS} and "
              f"{DS_CLASSES * DS_VAL_PER_CLASS}, COCO "
              f"instances of {DS_COCO_TRAIN} + {DS_COCO_VAL}, {DRIVER_PX} px, "
              f"made in {time.perf_counter() - t:.1f} s")

        # ---- in19k: the int8 encoder, the 19167-class head
        t = time.perf_counter()
        want = summed(enc_int8, trunk_launches(rec_cfg))
        got, seen = run_driver(r19k, f"{tag} in19k", [
            "--model", REC_MODEL, "--num_classes", str(REC_CLASSES),
            "--encoder", REC_ENCODER, "--encoder_quantization", "int8",
            "--batch_size", str(REC_BATCH), "--num_its", str(DS_ITS),
            "--save_freq", str(DS_SAVE_FREQ), "--log_freq", "1",
            "--num_workers", str(DRIVER_WORKERS), "--train_data_path",
            str(shard), "--output_dir", str(root / "in19k"),
            "--save_prefix", "r19"], want, totals)
        print(f"[{tag}] in19k ({time.perf_counter() - t:.1f} s)")
        graphs_off_against_default(f"{tag} in19k", r19k, [
            "--model", REC_MODEL, "--num_classes", str(REC_CLASSES),
            "--encoder", REC_ENCODER, "--encoder_quantization", "int8",
            "--batch_size", str(REC_BATCH), "--num_its",
            str(GRAPH_DRIVER_ITS), "--save_freq", "1000", "--log_freq", "1",
            "--num_workers", "0", "--train_data_path", str(shard),
            "--output_dir", str(root / "in19k_off"), "--save_prefix", "off"],
            GRAPH_DRIVER_ITS)
        rows = ds_rows(root / "in19k" / f"r19_{REC_MODEL}_log.txt")
        ckpt19 = root / "in19k" / f"r19_{REC_MODEL}_checkpoint"
        check([it for it, _ in seen] == list(range(DS_ITS))
              and got == times(want, DS_ITS),
              f"{tag} in19k: iterations {[it for it, _ in seen]}, launches "
              f"{got}, expected {times(want, DS_ITS)}")
        check(len(rows) == 1 and rows[0]["iteration"] == DS_SAVE_FREQ
              and set(rows[0]) == {"train_loss", "train_acc1", "train_acc5",
                                   "iteration"}
              and math.isfinite(rows[0]["train_loss"])
              and checkpoint_step(ckpt19) == DS_SAVE_FREQ,
              f"{tag} in19k: JSONL rows {rows}, checkpoint step "
              f"{checkpoint_step(ckpt19)}")
        ms = statistics.median(dt for _, dt in seen[1:]) * 1e3
        print(f"[{tag}] in19k: JSONL row {json.dumps(rows[0])}; checkpoint "
              f"at {DS_SAVE_FREQ}; launches per step {json.dumps(want)}; "
              f"{ms:.2f} ms/step at B={REC_BATCH} (median of steps 1-"
              f"{DS_ITS - 1}, {REC_BATCH / ms * 1e3:.1f} img/s, {label}) "
              f"({time.perf_counter() - t:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- in1k: the head swapped from in19k's, kernels vs reference
        t = time.perf_counter()
        want = summed(enc_bf16, trunk_launches(rec_cfg))
        evals = summed(enc_bf16, trunk_forward_launches(rec_cfg))
        res = {}
        for backend in ("kernel", "reference"):
            out = root / f"in1k_{backend}"
            got, seen = run_driver(r1k, f"{tag} in1k {backend}", [
                "--model", REC_MODEL, "--model_ckpt", str(ckpt19),
                "--pretrain_num_classes", str(REC_CLASSES), "--num_classes",
                str(DS_CLASSES), "--encoder", REC_ENCODER, "--batch_size",
                str(REC_BATCH), "--epochs", "1", "--log_freq", "1",
                # inline: worker processes hand their batches over in the
                # order they finish, and the two runs must see one order
                "--num_workers", "0", "--train_data_path", str(root / "train"),
                "--val_data_path", str(root / "val"), "--output_dir",
                str(out), "--save_prefix", "ft",
                *(["--attn_backend", "reference"] if backend == "reference"
                  else [])],
                want if backend == "kernel" else {},
                totals if backend == "kernel" else None)
            expect = (summed(times(want, len(seen)), evals)
                      if backend == "kernel" else {})
            check(len(seen) == 2 and got == expect,
                  f"{tag} in1k {backend}: {len(seen)} steps, launches {got}, "
                  f"expected {expect}")
            res[backend] = ds_rows(out / f"ft_{REC_MODEL}_log.txt")[0]
        row, ref = res["kernel"], res["reference"]
        blob, meta = load_checkpoint(root / "in1k_kernel" /
                                     f"ft_{REC_MODEL}_checkpoint")
        rel = abs(row["test_loss"] - ref["test_loss"]) / abs(ref["test_loss"])
        print(f"[{tag}] in1k: eval loss {row['test_loss']:.6f} vs "
              f"{ref['test_loss']:.6f} with --attn_backend reference, relative "
              f"{rel:.3g} (tolerance {DS_LOSS_RTOL}); acc1 {row['test_acc1']:.2f}"
              f" vs {ref['test_acc1']:.2f}; train loss {row['train_loss']:.6f} "
              f"vs {ref['train_loss']:.6f}; best-acc1 checkpoint: epoch "
              f"{meta['step']}, best_eval_acc1 {meta['best_eval_acc1']:.2f}, "
              f"head {tuple(blob['model']['head.weight'].shape)} "
              f"({time.perf_counter() - t:.1f} s)")
        check(set(row) == {"train_loss", "train_lr", "test_loss", "test_acc1",
                           "test_acc5", "epoch"} and rel <= DS_LOSS_RTOL
              and meta["best_eval_acc1"] == row["test_acc1"] > 0
              and tuple(blob["model"]["head.weight"].shape)
              == (DS_CLASSES, rec_cfg.decoder_embed_dim),
              f"{tag} in1k: rows {res}, checkpoint meta {meta}")
        del blob
        # by default and with --cuda_graphs off at a batch whose epoch and
        # eval replay their graphs: the mixup targets a static input
        off = root / "in1k_off"
        graphs_off_against_default(f"{tag} in1k", r1k, [
            "--model", REC_MODEL, "--model_ckpt", str(ckpt19),
            "--pretrain_num_classes", str(REC_CLASSES), "--num_classes",
            str(DS_CLASSES), "--encoder", REC_ENCODER, "--batch_size",
            str(GRAPH_IN1K_BATCH), "--epochs", "1", "--log_freq", "1",
            "--num_workers", "0", "--train_data_path", str(root / "train"),
            "--val_data_path", str(root / "val"), "--output_dir", str(off),
            "--save_prefix", "off"],
            DS_CLASSES * DS_TRAIN_PER_CLASS // GRAPH_IN1K_BATCH,
            off / f"off_{REC_MODEL}_log.txt")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- segmentation: an epoch with the kernels and with the plain
        #      versions, then --resume for the next
        t = time.perf_counter()
        want = summed(enc_bf16, trunk_launches(seg_cfg))
        evals = summed(enc_bf16, trunk_forward_launches(seg_cfg))
        n_eval = -(-DS_COCO_VAL // SEG_BATCH)
        mats: list = []
        real_eval = seg.evaluate

        def recorded(*a, **kw):
            confmat = real_eval(*a, **kw)
            mats.append(confmat.mat.copy())
            return confmat

        def seg_argv(out, *extra):
            return ["--dataset", "coco", "--data_path", str(coco),
                    "--model", SEG_MODEL, "--encoder", REC_ENCODER,
                    "--batch_size_per_gpu", str(SEG_BATCH), "--epochs", "1",
                    "--lr", str(DS_SEG_LR),
                    # inline, as in1k's runs (one batch order for both)
                    "--workers", "0", "--print_freq", "1",
                    "--output_dir", str(out), *extra]

        seg.evaluate = recorded
        try:
            res = {}
            for backend in ("kernel", "reference"):
                out = root / f"seg_{backend}"
                extra = (["--attn_backend", "reference"]
                         if backend == "reference" else [])
                got, seen = run_driver(
                    seg, f"{tag} segmentation {backend}",
                    seg_argv(out, *extra), want if backend == "kernel" else {},
                    totals if backend == "kernel" else None)
                expect = (summed(times(want, DS_COCO_TRAIN // SEG_BATCH),
                                 times(evals, n_eval))
                          if backend == "kernel" else {})
                check(len(seen) == DS_COCO_TRAIN // SEG_BATCH and got == expect,
                      f"{tag} segmentation {backend}: {len(seen)} steps, "
                      f"launches {got}, expected {expect}")
                res[backend] = ds_rows(out / "seg_log.txt")[0]
                if backend == "kernel":
                    seg_ms = statistics.median(dt for _, dt in seen[1:]) * 1e3
            got, seen = run_driver(seg, f"{tag} segmentation --resume", [
                *seg_argv(root / "seg_resumed", "--resume",
                          str(root / "seg_kernel" / "checkpoint")),
                "--epochs", "2"], want, totals)
        finally:
            seg.evaluate = real_eval
        graphs_off_against_default(f"{tag} segmentation", seg,
                                   seg_argv(root / "seg_off"),
                                   DS_COCO_TRAIN // SEG_BATCH,
                                   root / "seg_off" / "seg_log.txt")
        resumed = ds_rows(root / "seg_resumed" / "seg_log.txt")
        row, ref = res["kernel"], res["reference"]
        valid = [int(m.sum()) for m in mats]
        rel = abs(row["train_loss"] - ref["train_loss"]) / abs(ref["train_loss"])
        print(f"[{tag}] segmentation: train loss {row['train_loss']:.6f} vs "
              f"{ref['train_loss']:.6f} with --attn_backend reference, "
              f"relative {rel:.3g} (tolerance {DS_LOSS_RTOL}); mean IoU "
              f"{row['mean_iou']:.5f} vs {ref['mean_iou']:.5f}; valid val "
              f"pixels in the confusion matrices {valid}; --resume ran epochs "
              f"{[r['epoch'] for r in resumed]}, {len(seen)} steps; "
              f"{seg_ms:.2f} ms/step at B={SEG_BATCH} ({label})")
        check(valid[0] == valid[1] > 0 and rel <= DS_LOSS_RTOL
              and set(row) == {"train_loss", "train_lr", "mean_iou", "epoch"},
              f"{tag} segmentation: rows {res}, valid pixels {valid}")
        check([r["epoch"] for r in resumed] == [1]
              and checkpoint_step(root / "seg_resumed" / "checkpoint") == 1
              and len(seen) == DS_COCO_TRAIN // SEG_BATCH,
              f"{tag} segmentation --resume: rows {resumed}")

        # the first epoch's checkpoint outside the driver: the val images
        # through the kernels and through the plain versions
        model = models.create(SEG_MODEL, num_classes=SEG_CLASSES,
                              device="cuda")
        load_params(root / "seg_kernel" / "checkpoint", model)
        encoder = downstream_encoder(None)
        enc_policy, policy = Policy(param_dtype=torch.bfloat16), Policy()
        ds, _ = load_dataset("coco", coco, "val", SegEvalTransform(256))
        agree = total = 0
        with torch.no_grad():
            for i in range(0, len(ds), SEG_BATCH):
                items = [ds[j] for j in range(i, min(i + SEG_BATCH, len(ds)))]
                x = torch.from_numpy(np.stack([a for a, _ in items])).cuda()
                target = torch.from_numpy(np.stack([b for _, b in items])).cuda()
                pred = {}
                for backend in (None, "reference"):
                    z = encoder.forward_encoder(x, policy=enc_policy,
                                                backend=backend)
                    pred[backend] = model(z, policy=policy,
                                          backend=backend)["out"].argmax(1)
                keep = target != 255
                agree += int((pred[None] == pred["reference"])[keep].sum())
                total += int(keep.sum())
        share = agree / total
        print(f"[{tag}] segmentation checkpoint of epoch 0 outside the driver: "
              f"argmax predictions with the kernels equal the plain versions' "
              f"on {share:.5f} of {total} valid val pixels (at least "
              f"{DS_PRED_AGREE}) ({time.perf_counter() - t:.1f} s)")
        check(total == valid[0] and share >= DS_PRED_AGREE,
              f"{tag} segmentation: predictions agree on {share} of {total}")
        del model, encoder
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[{tag}] main path launches: {json.dumps(totals)} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return totals


# ---------------------------------------------------------------------------
# the multi-GPU layer (parallel/) and K18: AdamW with bf16 moments
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def p128_adamw_shapes() -> list[tuple[tuple[int, ...], bool]]:
    """(shape, decays) of every parameter of the full p128 model, in the
    optimizer's order (decayed group, then exempt)."""
    from tae_tpu_torch import models
    from tae_tpu_torch.train import no_decay_mask

    model = models.create(P128_FSDP_MODEL, device="meta")
    mask = no_decay_mask(model)
    named = list(model.named_parameters())
    return ([(tuple(p.shape), True) for n, p in named if mask[n]]
            + [(tuple(p.shape), False) for n, p in named if not mask[n]])


def phase_k18_kernel() -> dict:
    """K18 on the full p128 model's parameter list (fp32 parameters and
    gradients, bf16 moments, its two decay groups): three updates held bit
    for bit against its plain version tensor by tensor, timed beside its
    bound (20 bytes a parameter), the plain version and
    ``torch.optim.AdamW(fused=True)`` with fp32 moments on the same
    parameters (the nearest PyTorch call: not the same function). Inputs
    are drawn again from their seeds for the comparison, so that one copy
    of the 45 GB state is held at a time."""
    import gc

    import torch

    from tae_tpu_torch.ops.cuda.adamw import (adamw_update,
                                              adamw_update_reference,
                                              bias_corrections, decay_factor)

    shapes = p128_adamw_shapes()
    n_params = sum(math.prod(s) for s, _ in shapes)
    b1, b2, eps, lr = 0.9, 0.95, 1e-8, 1e-4
    decays = [decay_factor(lr, 0.05) if d else 1.0 for _, d in shapes]

    def draw(i, what, step=0):
        gen = torch.Generator(device="cuda").manual_seed(
            (1 + i) * 10 + step * 100_003 + {"p": 1, "m": 2, "v": 3, "g": 4}[what])
        x = torch.randn(shapes[i][0], generator=gen, device="cuda")
        if what == "m":
            return (x * 1e-2).to(torch.bfloat16)
        if what == "v":
            return (x.square() * 1e-4).to(torch.bfloat16)
        return x * 1e-2 if what == "g" else x

    def grads(step):
        return [draw(i, "g", step) for i in range(len(shapes))]

    t0 = time.perf_counter()
    ps = [draw(i, "p") for i in range(len(shapes))]
    ms = [draw(i, "m") for i in range(len(shapes))]
    vs = [draw(i, "v") for i in range(len(shapes))]
    k = len(shapes)
    before = adamw_update.launches
    for step in (1, 2, 3):
        gs = grads(step)
        c1, c2 = bias_corrections(b1, b2, step)
        adamw_update(ps, gs, ms, vs, decays, [lr] * k, [c1] * k, [c2] * k,
                     b1=b1, b2=b2, eps=eps)
        del gs
    torch.cuda.synchronize()
    launches = adamw_update.launches - before
    check(launches == 3, f"K18: {launches} launches for 3 updates of {k} "
                         "tensors (one a step expected)")
    same = 0
    for i in range(k):
        p, m, v = draw(i, "p"), draw(i, "m"), draw(i, "v")
        for step in (1, 2, 3):
            c1, c2 = bias_corrections(b1, b2, step)
            adamw_update_reference(p, draw(i, "g", step), m, v, lr=lr,
                                   decay=decays[i], b1=b1, b2=b2, eps=eps,
                                   c1=c1, c2=c2)
        same += (torch.equal(p, ps[i]) and torch.equal(m, ms[i])
                 and torch.equal(v, vs[i]))
    check(same == k, f"K18: {k - same} of {k} p128 tensors differ from the "
                     "plain version after 3 updates")
    print(f"[kernels] K18 adamw_update on p128's {k} tensors ({n_params} "
          f"parameters, fp32 / bf16 moments): parameters and both moments "
          f"bit-equal to the plain version after 3 updates, one launch each "
          f"({time.perf_counter() - t0:.1f} s)")

    gs = grads(4)
    c1, c2 = bias_corrections(b1, b2, 4)

    def kernel():
        adamw_update(ps, gs, ms, vs, decays, [lr] * k, [c1] * k, [c2] * k,
                     b1=b1, b2=b2, eps=eps)

    def plain():
        for i in range(k):
            adamw_update_reference(ps[i], gs[i], ms[i], vs[i], lr=lr,
                                   decay=decays[i], b1=b1, b2=b2, eps=eps,
                                   c1=c1, c2=c2)

    ms_kernel = time_ms_events(kernel)
    ms_plain = timed_calls(plain, 2)
    bnd = bound(20 * n_params, 10 * n_params, "fp32")
    del ms[:], vs[:]
    gc.collect()
    torch.cuda.empty_cache()
    params = [torch.nn.Parameter(p) for p in ps]
    for p, g in zip(params, gs):
        p.grad = g
    fused = torch.optim.AdamW(
        [dict(params=[p for p, (_, d) in zip(params, shapes) if d],
              weight_decay=0.05),
         dict(params=[p for p, (_, d) in zip(params, shapes) if not d],
              weight_decay=0.0)], lr=lr, betas=(b1, b2), eps=eps, fused=True)
    ms_fused = timed_calls(fused.step, 5)
    print(f"[kernels] K18 on p128's parameter list: kernel {ms_kernel:.4f} ms, "
          f"plain {ms_plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}: 20 B a "
          f"parameter); torch.optim.AdamW(fused=True) with fp32 moments "
          f"{ms_fused:.4f} ms (28 B a parameter: bound "
          f"{28 * n_params / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    del fused, params, ps, gs
    gc.collect()
    torch.cuda.empty_cache()
    return {K18["name"]: [dict(
        case=f"p128 parameter list ({k} tensors, {n_params} parameters), "
             "fp32 parameters and gradients, bf16 moments",
        max_abs_err=0.0, ms=ms_kernel, plain_ms=ms_plain, bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=ms_fused,
        library_is="torch.optim.AdamW(fused=True), fp32 moments (28 B a "
                   "parameter; the nearest PyTorch call, not the same "
                   "function)")]}


def timed_calls(fn, reps: int) -> float:
    """Device time of one call of a long-running ``fn`` in ms: ``reps``
    calls between CUDA events after one warm-up."""
    import torch

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


def plain_adamw(init):
    """``AdamWMoments``' update through K18's plain version, tensor by
    tensor, as an Optimizer of ``init``: the optimizer of the
    ``backend="reference"`` run, whose steps run eagerly (its device part
    reads the step counts on the host)."""
    from tae_tpu_torch.train.optim import Optimizer

    def host(opt, lr, plan):
        for group in opt.param_groups:
            group["lr"] = float(lr)

    return Optimizer(init=init, bind=lambda opt, plan=None: None, host=host,
                     apply=lambda opt, plan: plain_adamw_update(
                         opt, opt.param_groups[0]["lr"]))


def plain_adamw_update(opt, lr: float) -> None:
    """``AdamWMoments``' step through K18's plain version, tensor by
    tensor."""
    import torch

    from tae_tpu_torch.ops.cuda.adamw import (adamw_update_reference,
                                              bias_corrections, decay_factor)

    with torch.no_grad():
        for group in opt.param_groups:
            group["lr"] = float(lr)
            (b1, b2), eps = group["betas"], group["eps"]
            decay = decay_factor(lr, group["weight_decay"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = opt._state(p)
                state["step"] += 1
                c1, c2 = bias_corrections(b1, b2, int(state["step"]))
                adamw_update_reference(p, p.grad, state["exp_avg"],
                                       state["exp_avg_sq"], lr=lr,
                                       decay=decay, b1=b1, b2=b2, eps=eps,
                                       c1=c1, c2=c2)


class WholeGrads:
    """A sharded model's parameters with their whole gradients, as
    ``compare_gradients`` reads a model."""

    class _Param:
        def __init__(self, grad):
            self.grad = grad

    def __init__(self, model):
        self._params = [(n, self._Param(p.grad.full_tensor()))
                        for n, p in model.named_parameters()]

    def named_parameters(self):
        return iter(self._params)

    def parameters(self):
        return (p for _, p in self._params)


def setup_world1():
    """This process's own world of 1 over NCCL and its (1, 1, 1) mesh."""
    from tae_tpu_torch.parallel import initialize_distributed, make_mesh

    device = initialize_distributed(
        init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
        device_type="cuda")
    mesh = make_mesh(1, 1, 1)
    return mesh, device


def p128_fsdp_trainer(mesh, moment_dtype, backend=None,
                      name=P128_FSDP_MODEL, clip_grad=None, bias_std=None,
                      **overrides):
    """The p128 model (or model ``name``; fp32 parameters from seed 0),
    placed on ``mesh`` (None: left whole), its AdamW state with
    ``moment_dtype`` and the ``train_bf16`` recipe's step (bf16 compute,
    decay 0.05, ``step_lr(1e-4, 1e-5, 450_000)``; gradients clipped to the
    norm ``clip_grad`` where given). ``bias_std``: the linear layers'
    biases, zeros at init, drawn from N(0, bias_std²) (seed 1) instead.
    With ``backend="reference"`` the update is K18's plain version."""
    import torch

    from tae_tpu_torch import models
    from tae_tpu_torch.parallel import shard_model
    from tae_tpu_torch.profile_training import WEIGHT_DECAY
    from tae_tpu_torch.train import (TrainState, adamw, make_train_step,
                                     step_lr)
    from tae_tpu_torch.utils.dtypes import Policy

    model = models.create(name, device="cuda", trainable=True, **overrides)
    model.init_weights_(torch.Generator(device="cuda").manual_seed(0))
    if bias_std is not None:
        from tae_tpu_torch.nn.vit import Linear

        gen = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, Linear) and m.bias is not None:
                    m.bias.normal_(0.0, bias_std, generator=gen)
    shard_model(model, mesh)
    opt = adamw(weight_decay=WEIGHT_DECAY, moment_dtype=moment_dtype)
    if backend == "reference":
        opt = plain_adamw(opt.init)
    policy = Policy()

    def loss_fn(m, batch):
        return m(batch, policy=policy, backend=backend)[0], {}

    step = make_train_step(loss_fn, opt, step_lr(1e-4, 1e-5, 450_000),
                           clip_grad=clip_grad,
                           cuda_graphs=False if backend == "reference"
                           else None)
    return TrainState.create(model, opt), step


def p128_fsdp_batch(b: int, seed: int = 4):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, 3, 256, 256), generator=gen, device="cuda")


def phase_train_p128_fsdp(label: str) -> dict:
    """Path ``train_p128_fsdp``: the full p128 model (22 + 22 blocks, width
    2560) placed by ``parallel.shard_model`` on this process's (1, 1, 1)
    mesh over NCCL, AdamW with bf16 moments (K18), B = 64, three steps with
    every kernel's launches checked (K18 once a step); step time, images
    per second and peak memory beside the 44.81 GB floor (12 bytes a
    parameter), then the same model's peak with fp32 moments
    (``torch.optim.AdamW(fused=True)`` on FSDP2's DTensors). First, at
    2 + 2 blocks, the step is held bit for bit against the same model and
    K18 without ``fully_shard``, and to ``backend="reference"`` with K18's
    plain version under the train gates. Returns the launch counts."""
    import gc

    import torch

    tag = "train_p128_fsdp"
    mesh, device = setup_world1()
    fns = wrappers()
    bf16 = torch.bfloat16
    batch = p128_fsdp_batch(P128_FSDP_BATCH)

    # ---- 1. 2 + 2: sharded, unwrapped and the reference
    cut = dict(depth=2, decoder_depth=2)
    sharded, step = p128_fsdp_trainer(mesh, bf16, **cut)
    whole, whole_step = p128_fsdp_trainer(None, bf16, **cut)
    ref, ref_step = p128_fsdp_trainer(None, bf16, "reference", **cut)
    cfg = whole.model.cfg
    want = dict(train_launches(cfg), adamw_update=1)
    m_s, _ = counted_step(tag, step, sharded, batch, 0, want, {})
    m_w, _ = counted_step(tag, whole_step, whole, batch, 0, want, {})
    m_r, _ = counted_step(tag, ref_step, ref, batch, 0, {}, {})
    loss_s, loss_w, loss_r = (float(m["loss"]) for m in (m_s, m_w, m_r))
    same = loss_s == loss_w and all(
        torch.equal(p.full_tensor(), q) for p, q in
        zip(sharded.model.parameters(), whole.model.parameters()))
    print(f"[{tag}] 2+2 blocks, B={P128_FSDP_BATCH}: loss under fully_shard "
          f"{loss_s!r}, without {loss_w!r}; updated parameters bit-equal: "
          f"{same} (a (1, 1, 1) mesh gathers each block's parameters into a "
          f"buffer of its own and reduces nothing: the same kernels on the "
          f"same bits)")
    check(same, f"{tag}: the step under fully_shard differs from the "
                "unwrapped model's")
    print(f"[{tag}] 2+2 vs backend='reference' with K18's plain version: "
          f"loss {loss_s:.6f} vs {loss_r:.6f} (rtol {TRAIN_LOSS_RTOL})")
    check(abs(loss_s - loss_r) <= TRAIN_LOSS_RTOL * abs(loss_r),
          f"{tag}: losses differ from the reference")
    compare_gradients(tag, WholeGrads(sharded.model), ref.model,
                      TRAIN_GRAD_REL_TOL)
    del sharded, whole, ref, step, whole_step, ref_step, m_s, m_w, m_r
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2. the main path: full depth, bf16 moments, three steps
    def run(moment_dtype, steps, totals):
        t = time.perf_counter()
        state, step = p128_fsdp_trainer(mesh, moment_dtype)
        cfg = state.model.cfg
        n = sum(p.numel() for p in state.model.parameters())
        built = time.perf_counter() - t
        want = dict(train_launches(cfg),
                    adamw_update=1 if moment_dtype is not None else 0)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        for f in fns.values():
            f.launches = 0
        losses, times = [], []
        for it in range(steps):
            m, dt = counted_step(tag, step, state, batch, it, want, totals)
            losses.append(float(m["loss"]))
            times.append(dt)
        peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(x) for x in losses),
              f"{tag}: losses {losses}")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        return cfg, n, built, want, losses, times, peak

    totals: dict = {}
    cfg, n, built, want, losses, times, peak = run(bf16, P128_FSDP_STEPS,
                                                   totals)
    floor = 12 * n
    ms = statistics.median(times[1:]) * 1e3
    check(cfg.depth == 22 and cfg.decoder_depth == 22
          and cfg.embed_dim == 2560, f"{tag}: not the full model ({cfg})")
    check(all(totals.get(k, 0) == v * P128_FSDP_STEPS for k, v in
              want.items()), f"{tag}: launches {totals}, per step {want}")
    print(f"[{tag}] {P128_FSDP_MODEL}: {n} fp32 parameters, "
          f"{cfg.depth}+{cfg.decoder_depth} blocks, width {cfg.embed_dim}, "
          f"{cfg.num_patches} tokens, fully_shard on a (1, 1, 1) mesh over "
          f"NCCL, AdamW bf16 moments (K18), built in {built:.1f} s")
    print(f"[{tag}] {P128_FSDP_STEPS} steps at B={P128_FSDP_BATCH}: losses "
          f"{' '.join(f'{x:.6f}' for x in losses)}; {ms:.2f} ms/step "
          f"(median of steps 2-{P128_FSDP_STEPS}; first {times[0] * 1e3:.2f}),"
          f" {P128_FSDP_BATCH / ms * 1e3:.1f} img/s; peak memory "
          f"{peak / 1e9:.2f} GB ({peak / 2 ** 30:.2f} GiB) beside the "
          f"{floor / 1e9:.2f} GB floor of parameters, gradients and bf16 "
          f"moments (12 B a parameter); {label}")
    print(f"[{tag}] launches per step: {json.dumps(want)}")

    # ---- 3. the same model with fp32 moments (fused torch AdamW on DTensors)
    _, _, _, _, losses32, times32, peak32 = run(None, 2, {})
    print(f"[{tag}] fp32 moments (torch.optim.AdamW(fused=True) on FSDP2's "
          f"DTensor parameters): losses {' '.join(f'{x:.6f}' for x in losses32)}"
          f", {times32[-1] * 1e3:.2f} ms for step 2; peak memory "
          f"{peak32 / 1e9:.2f} GB ({peak32 / 2 ** 30:.2f} GiB) beside the "
          f"{16 * n / 1e9:.2f} GB floor (16 B a parameter); bf16 moments "
          f"saved {(peak32 - peak) / 1e9:.2f} GB")
    check(losses32[0] == losses[0], f"{tag}: the first loss depends on the "
                                    "moments' type")
    return totals


def _world2_rank(rank: int, world: int) -> dict:
    """One rank of the world-2 probe: gloo on CUDA tensors of one card, the
    p128 model at 2 + 2 on a (1, 2, 1) mesh, one step of the global batch."""
    import torch

    from tae_tpu_torch.dryrun import global_mean
    from tae_tpu_torch.parallel import batch_slice, make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, world, 1, device_type="cuda")
    state, step = p128_fsdp_trainer(mesh, torch.bfloat16, depth=2,
                                    decoder_depth=2)
    batch = batch_slice(p128_fsdp_batch(P128_FSDP_BATCH), mesh)
    _, m = step(state, batch, 0)
    torch.cuda.synchronize()
    return dict(loss=global_mean(m["loss"], mesh),
                grad_norm=float(m["grad_norm"]),
                local=[tuple(p.to_local().shape)
                       for p in state.model.parameters()][:2])


def phase_world2() -> None:
    """Two ranks on the one card: FSDP2 over gloo on CUDA tensors (NCCL
    refuses two ranks on one device), the p128 step at 2 + 2 on a
    (1, 2, 1) mesh against this process's unwrapped step of the same global
    batch. Prints the outcome; a collective that gloo cannot carry fails
    here, with its error."""
    import tempfile

    import torch

    from tae_tpu_torch.parallel import spawn

    tag = "world2"
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn.run(_world2_rank, 2, store=str(pathlib.Path(tmp) / "s"),
                          timeout=WORLD2_TIMEOUT)
    state, step = p128_fsdp_trainer(None, torch.bfloat16, depth=2,
                                    decoder_depth=2)
    _, m = step(state, p128_fsdp_batch(P128_FSDP_BATCH), 0)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    del state, step
    torch.cuda.empty_cache()
    got = ranks[0]
    print(f"[{tag}] gloo, 2 ranks on one card, FSDP2 all-gather and "
          f"reduce-scatter on CUDA tensors: ok; p128 2+2 at B="
          f"{P128_FSDP_BATCH} on (1, 2, 1) (rank 0 holds {got['local']} of "
          f"its first parameters): loss {got['loss']!r} vs {loss!r} in one "
          f"process (rtol {WORLD2_LOSS_RTOL}), gradient norm "
          f"{got['grad_norm']!r} vs {norm!r} (rtol {WORLD2_NORM_RTOL}: each "
          f"rank's bf16 weight gradients over its own rows) "
          f"({time.perf_counter() - t:.1f} s)")
    check(abs(got["loss"] - loss) <= WORLD2_LOSS_RTOL * abs(loss)
          and abs(got["grad_norm"] - norm) <= WORLD2_NORM_RTOL * norm,
          f"{tag}: two ranks differ from one process")


def tensor2_counted(fn):
    """``fn()``, its host wall time to a synchronize (ms) and every
    kernel's launches in it (the counts set to 0 just before and read just
    after)."""
    import torch

    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    return value, (time.perf_counter() - t) * 1e3, {
        name: f.launches for name, f in fns.items() if f.launches}


def tensor2_whole(state, names, moment: bool = False) -> dict:
    """name -> the parameter (or, with ``moment``, its AdamW first moment)
    whole, in fp32 on the host, a split qkv in the reference's rows. A
    split leaf's shards are gathered over the tensor peers by
    ``dist.all_gather`` on host copies, which every peer calls (on CUDA
    tensors under gloo, ``DTensor.full_tensor``'s functional all-gather
    ends the process with a segmentation fault); FSDP2's share is the whole
    on a (1, 1, 2) mesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from tae_tpu_torch.parallel.tensor import local_shard, to_reference

    params = dict(state.model.named_parameters())
    out = {}
    for n in names:
        t = state.opt.state[params[n]]["exp_avg"] if moment else params[n]
        whole = local_shard(t).detach().to("cpu", torch.float32, copy=True)
        if isinstance(t, DTensor) and "tensor" in t.device_mesh.mesh_dim_names:
            sub = t.device_mesh["tensor"]
            cut = t.placements[t.device_mesh.mesh_dim_names.index("tensor")]
            check(isinstance(cut, Shard), f"{n}: {t.placements}")
            parts = [torch.empty_like(whole) for _ in range(sub.size())]
            dist.all_gather(parts, whole, group=sub.get_group())
            whole = torch.cat(parts, cut.dim)
        check(tuple(whole.shape) == tuple(t.shape),
              f"{n}: gathered {tuple(whole.shape)} of {tuple(t.shape)}")
        out[n] = whole
    return to_reference(out, state.model)


def tensor2_train(mesh, tag: str) -> dict:
    """One step of model ``tag`` (``TENSOR2_TRAIN``) on ``mesh`` (None:
    unsplit): its global loss, gradient norm (before clipping), wall time,
    launches and heads a rank, and the ``TENSOR2_LEAVES`` of its first and
    last blocks whole (their update in the step and their first moment
    after it, each an fp32 tensor on the host)."""
    import torch

    from tae_tpu_torch.dryrun import global_mean
    from tae_tpu_torch.parallel import batch_slice

    name, b, clip, overrides = TENSOR2_TRAIN[tag]
    began = time.perf_counter()
    state, step = p128_fsdp_trainer(mesh, torch.bfloat16, name=name,
                                    clip_grad=clip, bias_std=TENSOR2_BIAS_STD,
                                    **overrides)
    cfg = state.model.cfg
    names = [f"{stack}.{leaf}" for stack in
             ("blocks.0", f"decoder_blocks.{cfg.decoder_depth - 1}")
             for leaf in TENSOR2_LEAVES]
    before = tensor2_whole(state, names)
    batch = batch_slice(p128_fsdp_batch(b, seed=6), mesh)
    (_, m), ms, launches = tensor2_counted(lambda: step(state, batch, 0))
    after = tensor2_whole(state, names)
    # unsplit in a rank: this rank's loss is the whole batch's
    loss = float(m["loss"]) if mesh is None else global_mean(m["loss"], mesh)
    out = dict(loss=loss, grad_norm=float(m["grad_norm"]), ms=ms,
               launches=launches, heads=state.model.blocks[0].attn.num_heads,
               cfg=cfg, update={n: after[n] - before[n] for n in names},
               moment=tensor2_whole(state, names, moment=True),
               seconds=time.perf_counter() - began)
    del state, step, m
    torch.cuda.empty_cache()
    return out


def tensor2_errors(got: dict, want: dict) -> dict:
    """The relative errors of ``got``'s loss and gradient norm, and the
    largest relative Frobenius error of its leaves' updates and of their
    first moments, each against ``want``'s, with the leaf at each."""
    out = dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
               grad_norm=abs(got["grad_norm"] - want["grad_norm"])
               / want["grad_norm"], seconds=got["seconds"])
    for k in ("update", "moment"):
        errs = {n: rel_err(got[k][n], want[k][n]) for n in want[k]}
        out[f"{k}_at"] = max(errs, key=errs.get)
        out[k] = errs[out[f"{k}_at"]]
    return out


@contextlib.contextmanager
def tensor2_control(kind: str):
    """The split with one fault of ``TENSOR2_CONTROLS`` put in, for as long
    as the context lasts."""
    import torch

    import tae_tpu_torch.parallel.tensor as tp

    if kind == "bf16_sum":
        real, attr = tp._sum_f32, "_sum_f32"
        setattr(tp, attr, lambda t, group: real(t, group).to(
            torch.bfloat16).float())
        owner = tp
    else:
        owner, attr = tp.TensorSplit, "enter"
        real = owner.enter
        owner.enter = lambda self, x: x
    try:
        yield
    finally:
        setattr(owner, attr, real)


def tensor2_work(mesh) -> dict:
    """The tensor2 phase's work on ``mesh`` (None: this process, unsplit):
    (a) one train step of the flagship at full width and depth, (b) one of
    p128 at 2 + 2 blocks, (c) a bf16 Tokenizer's encode of a p16 batch.
    Each with its loss and gradient norm or latents, its host wall time to
    a synchronize, its heads a rank and every kernel's launches in it. On
    a mesh the split step (``errors``) and each control of
    ``TENSOR2_CONTROLS`` (``controls``) are also held against the same step
    unsplit in this rank."""
    import torch

    from tae_tpu_torch.models import create
    from tae_tpu_torch.tokenizer import Tokenizer

    out = {}
    for tag in TENSOR2_TRAIN:
        if mesh is None:
            got = tensor2_train(None, tag)
        else:
            want = tensor2_train(None, tag)
            got = tensor2_train(mesh, tag)
            got["errors"] = tensor2_errors(got, want)
            got["controls"] = {}
            for kind in TENSOR2_CONTROLS:
                with tensor2_control(kind):
                    control = tensor2_train(mesh, tag)
                got["controls"][kind] = tensor2_errors(control, want)
                del control
            del want
        del got["update"], got["moment"]
        out[tag] = got
    tok = Tokenizer.from_checkpoint(TENSOR2_MODEL, dtype=torch.bfloat16,
                                    device="cuda", mesh=mesh,
                                    cuda_graphs=None if mesh else False)
    images = p128_fsdp_batch(TENSOR2_ENCODE_BATCH, seed=7)
    tok.encode(images)                                      # warm
    z, ms, launches = tensor2_counted(lambda: tok.encode(images))
    out["encode"] = dict(z=z.float().cpu().numpy(), ms=ms, launches=launches,
                         heads=tok.model.blocks[0].attn.num_heads,
                         cfg=create(TENSOR2_MODEL, device="meta").cfg,
                         eager=not tok.cuda_graphs)
    del tok
    torch.cuda.empty_cache()
    return out


def _tensor2_rank(rank: int, world: int) -> dict:
    """One rank of the tensor2 phase: gloo on CUDA tensors of one card, a
    (1, 1, 2) mesh."""
    import torch

    from tae_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    return tensor2_work(make_mesh(1, 1, world, device_type="cuda"))


def phase_tensor2(label: str) -> dict:
    """Path ``tensor2``: every block split over the tensor axis of a
    (1, 1, 2) mesh of two gloo ranks on the one card (NCCL refuses two
    ranks on one device), each rank running the kernels on its own heads;
    :func:`tensor2_work` on both ranks against this process's unsplit run
    (loss, gradient norm, latents) and, in each rank, against its own
    unsplit step (the leaves' updates and first moments too), beside the
    controls, each of which must miss the limits it is named with. Each
    rank's launches are held to the unsplit model's per-step
    counts (per encode for the Tokenizer). Returns rank 0's launches."""
    import tempfile

    import numpy as np
    import torch

    from tae_tpu_torch.parallel import spawn

    tag = "tensor2"
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn.run(_tensor2_rank, 2, store=str(pathlib.Path(tmp) / "s"),
                          timeout=TENSOR2_TIMEOUT)
    spawned = time.perf_counter() - t
    one = tensor2_work(None)
    totals: dict = {}
    for what in TENSOR2_TRAIN:
        want, cfg = one[what], one[what]["cfg"]
        limits = TENSOR2_LIMITS[what]
        # the bf16 moments: one K18 launch a step
        launches = dict(train_launches(cfg), adamw_update=1)
        check(want["launches"] == launches,
              f"{tag} {what}: one process launched {want['launches']}, "
              f"expected {launches}")
        for rank, r in enumerate(ranks):
            got = r[what]
            check(got["launches"] == launches,
                  f"{tag} {what} rank {rank}: launches {got['launches']}, "
                  f"expected {launches}")
            check(got["heads"] * 2 == want["heads"],
                  f"{tag} {what} rank {rank}: {got['heads']} heads a rank "
                  f"of {want['heads']}")
        got = ranks[0][what]
        loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        norm_err = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        clip = TENSOR2_TRAIN[what][2]
        print(f"[{tag}] {what}: {cfg.depth}+{cfg.decoder_depth} blocks of "
              f"width {cfg.embed_dim}, {got['heads']} heads a rank of "
              f"{want['heads']}, one train_bf16 step (bf16 moments"
              + ("" if clip is None else f", gradients clipped to {clip}")
              + f"): loss {got['loss']!r} vs {want['loss']!r} in one process "
              f"(relative {loss_err:.3g}, tolerance {limits['loss']:.3g}), "
              f"gradient norm {got['grad_norm']!r} vs {want['grad_norm']!r} "
              f"(relative {norm_err:.3g}, tolerance "
              f"{limits['grad_norm']:.3g}); launches a rank "
              f"{json.dumps(launches)}")
        for head, e in (("the split", got["errors"]),
                        *((f"control {kind}", got["controls"][kind])
                          for kind in TENSOR2_CONTROLS)):
            print(f"[{tag}] {what}, {head}, against the same step unsplit "
                  f"in rank 0 ({', '.join(TENSOR2_LEAVES)} of the first and "
                  f"last blocks): loss {e['loss']:.3g}, gradient norm "
                  f"{e['grad_norm']:.3g}, updates at most {e['update']:.3g} "
                  f"({e['update_at']}), first moments at most "
                  f"{e['moment']:.3g} ({e['moment_at']}); built and run in "
                  f"{e['seconds']:.1f} s")
        print(f"[{tag}] {what} limits {json.dumps(limits)}")
        print(f"[{tag}] {what} step wall (host clock to a synchronize, first "
              f"step): rank 0 {ranks[0][what]['ms']:.1f} ms, rank 1 "
              f"{ranks[1][what]['ms']:.1f} ms, one process unsplit "
              f"{want['ms']:.1f} ms; {label}")
        check(loss_err <= limits["loss"] and norm_err <= limits["grad_norm"],
              f"{tag} {what}: the split step differs from one process")
        for rank, r in enumerate(ranks):
            e = r[what]["errors"]
            check(all(e[k] <= v for k, v in limits.items()),
                  f"{tag} {what} rank {rank}: the split step differs from "
                  f"the rank's unsplit step: {e}, limits {limits}")
        for kind, missed in TENSOR2_CONTROLS.items():
            e = got["controls"][kind]
            check(all(e[k] > limits[k] for k in missed),
                  f"{tag} {what}: control {kind} meets a limit of {missed}: "
                  f"{e}, limits {limits}")
        for name, n in got["launches"].items():
            totals[name] = totals.get(name, 0) + n
    want = one["encode"]
    per_encode = expected_launches(want["cfg"], None)["encode"]
    check(want["launches"] == per_encode,
          f"{tag} encode: one process launched {want['launches']}, expected "
          f"{per_encode}")
    for rank, r in enumerate(ranks):
        got = r["encode"]
        err = rel_err(torch.from_numpy(got["z"]), torch.from_numpy(want["z"]))
        check(got["eager"] and got["launches"] == per_encode
              and got["heads"] * 2 == want["heads"]
              and bool(np.isfinite(got["z"]).all()) and err <= SLICE_REL_TOL,
              f"{tag} encode rank {rank}: launches {got['launches']} (expected "
              f"{per_encode}), heads {got['heads']}, relative error {err:.3g}")
    err = rel_err(torch.from_numpy(ranks[0]["encode"]["z"]),
                  torch.from_numpy(want["z"]))
    print(f"[{tag}] bf16 Tokenizer on (1, 1, 2), eager: encode of "
          f"{TENSOR2_ENCODE_BATCH} p16 images, latents "
          f"{tuple(want['z'].shape)} within {err:.3g} of one process's "
          f"(relative Frobenius, tolerance {SLICE_REL_TOL}); encode wall "
          f"rank 0 {ranks[0]['encode']['ms']:.2f} ms, rank 1 "
          f"{ranks[1]['encode']['ms']:.2f} ms, one process eager "
          f"{want['ms']:.2f} ms; launches a rank {json.dumps(per_encode)}")
    for name, n in ranks[0]["encode"]["launches"].items():
        totals[name] = totals.get(name, 0) + n
    print(f"[{tag}] two ranks spawned and run in {spawned:.1f} s, the "
          f"unsplit runs in {time.perf_counter() - t - spawned:.1f} s; main "
          f"path launches (rank 0): {json.dumps(totals)}")
    return totals


def phase_drivers_mesh() -> dict:
    """Path ``drivers_mesh``: ``cli.train`` as a torchrun launch of one
    (``WORLD_SIZE=1``, ``--mesh_fsdp 1``: the model under FSDP2 on this
    process's NCCL group, eager) against the same driver without a mesh
    (from CUDA graphs), on the ``drivers`` path's data and recipe (the p16
    model at DRIVER_MESH_CUT's depth, B = 64, 3 steps, inline loading so
    that both see the same batches); each step's losses and launches.
    Returns the mesh run's launch counts."""
    import os
    import tempfile

    import torch

    from tae_tpu_torch.cli import train
    from tae_tpu_torch.data.fake import make_fake_wds_shard
    from tae_tpu_torch.models import create

    tag = "drivers_mesh"
    cfg = create(DRIVER_MODEL, device="meta", **DRIVER_MESH_CUT).cfg
    want = train_launches(cfg)
    real = train.make_train_step
    fns = wrappers()

    def counted_make(losses):
        def make(*a, **kw):
            step = real(*a, **kw)

            def counted(state, batch, it):
                out, _ = counted_request(f"{tag} iteration {it}", fns, {},
                                         lambda x: step(*x), (state, batch,
                                                              it), want)
                losses.append(float(out[1]["loss"]))
                return out

            return counted
        return make

    def run(root, out, env, losses):
        args = train.get_args_parser().parse_args([
            "--model", DRIVER_MODEL, "--batch_size_per_gpu", str(DRIVER_BATCH),
            "--num_its", "3", "--save_freq", "1000", "--log_freq", "1",
            "--train_data_path", str(root / "train-000000.tar"),
            "--val_data_path", str(root), "--num_workers", "0",
            "--output_dir", str(out), "--save_prefix", "tr",
            "--mesh_fsdp", "1", "--model_args", json.dumps(DRIVER_MESH_CUT)])
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        train.make_train_step = counted_make(losses)
        try:
            return driven({} if env else None, train.main, args)[1]
        finally:
            train.make_train_step = real
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        make_fake_wds_shard(root / "train-000000.tar",
                            num_samples=DRIVER_SHARD, size=DRIVER_PX, seed=0)
        plain, meshed = [], []
        t = time.perf_counter()
        run(root, root / "plain", {}, plain)
        got = run(root, root / "mesh", dict(WORLD_SIZE="1", RANK="0",
                                            LOCAL_RANK="0"), meshed)
    torch.cuda.empty_cache()
    print(f"[{tag}] cli.train with WORLD_SIZE=1 --mesh_fsdp 1 (FSDP2 on a "
          f"(1, 1, 1) mesh): losses {meshed}; without a mesh: {plain} "
          f"(bit-equal: {meshed == plain}); launches per step "
          f"{json.dumps(want)} ({time.perf_counter() - t:.1f} s)")
    check(len(meshed) == len(plain) == 3 and all(
        abs(a - b) <= DRIVER_MESH_RTOL * abs(b) for a, b in zip(meshed, plain)),
        f"{tag}: losses {meshed} vs {plain}")
    print(f"[{tag}] main path launches: {json.dumps(got)}")
    return got


# ---------------------------------------------------------------------------
# train_graphs: the train steps from captured CUDA graphs against eager
# ---------------------------------------------------------------------------

def training_tensors(state) -> list:
    """(name, tensor) of every parameter of ``state`` and every tensor of
    its optimizer state (moments, step counts)."""
    import torch

    out = []
    for name, p in state.model.named_parameters():
        out.append((name, p))
        for k, v in state.opt.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                out.append((f"{name}:{k}", v))
    return out


def state_difference(got, want) -> tuple[int, float, str]:
    """Tensors of two training states that are not bit-equal: their count,
    the largest absolute difference and the name of its tensor."""
    import torch

    unequal, worst, where = 0, 0.0, ""
    for (name, a), (_, b) in zip(training_tensors(got),
                                 training_tensors(want)):
        if torch.equal(a, b):
            continue
        unequal += 1
        d = float((a.float() - b.float()).abs().max())
        if d >= worst:
            worst, where = d, name
    return unequal, worst, where


def graph_steps(tag: str, step, state, batch, want: dict, totals: dict):
    """GRAPH_STEPS steps of ``step`` on ``batch``, each step's launches held
    to ``want`` and added to ``totals``: each step's (loss, grad_norm, lr)
    and host wall."""
    rows, walls = [], []
    for it in range(GRAPH_STEPS):
        m, dt = counted_step(tag, step, state, batch, it, want, totals)
        rows.append(tuple(float(m[k]) for k in ("loss", "grad_norm", "lr")))
        walls.append(dt)
    return rows, walls


def graph_against_eager(tag: str, build, batch, want: dict, totals: dict,
                        optimizer) -> dict:
    """One recipe eager and from graphs. ``build(cuda_graphs)`` makes a
    fresh (state, step) from the recipe's seed; the eager run first, then
    the graph run (the main path: its launches go into ``totals``), each
    GRAPH_STEPS steps on ``batch`` with the learning rate switching at
    GRAPH_SWITCH. Each step's loss, gradient norm and learning rate must be
    equal, and every parameter, moment and step count after the last step
    bit-equal; then the graph's kernel nodes against the eager step's
    (check_step_replay), the replay's device time alone, the host time of
    the optimizer's host part and of the graph's model check, and the peak
    memory of each run over its base. Returns the numbers printed."""
    import gc

    import torch

    from tae_tpu_torch.serving_graphs import _unchanged

    fns = wrappers()
    runs = {}
    for mode in (False, None):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, step = build(mode)
        if mode is None:
            # the main path: every count is 0 here
            for f in fns.values():
                f.launches = 0
        # the graph is checked below, after the runs' peaks are read
        with graph_checks_off():
            rows, walls = graph_steps(tag, step, state, batch, want,
                                      totals if mode is None else {})
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        if mode is False:
            state.opt.zero_grad(set_to_none=True)
        runs[mode] = dict(state=state, step=step, rows=rows, walls=walls,
                          peak=peak)
    eager, graph = runs[False], runs[None]
    check(len(graph["step"].graphs.graphs(graph["state"])) == 1,
          f"{tag}: the graph run holds "
          f"{len(graph['step'].graphs.graphs(graph['state']))} graphs")
    lrs = [r[2] for r in graph["rows"]]
    check(lrs[GRAPH_SWITCH - 1] != lrs[GRAPH_SWITCH],
          f"{tag}: the learning rate does not switch ({lrs})")
    same_rows = graph["rows"] == eager["rows"]
    unequal, worst, where = state_difference(graph["state"], eager["state"])
    n_tensors = len(training_tensors(graph["state"]))
    print(f"[{tag}] {GRAPH_STEPS} steps eager and from a CUDA graph (eager "
          f"step 0, capture at 1, replays after; lr "
          f"{lrs[0]:.3g} -> {lrs[-1]:.3g} at step {GRAPH_SWITCH}): (loss, "
          f"grad_norm, lr) equal at every step: {same_rows}; of {n_tensors} "
          f"parameters, moments and step counts after step {GRAPH_STEPS}, "
          f"{unequal} not bit-equal (largest difference {worst:.3g}"
          f"{' in ' + where if where else ''})")
    if not same_rows:
        for i, (a, b) in enumerate(zip(graph["rows"], eager["rows"])):
            print(f"[{tag}]   step {i}: graph {a!r} eager {b!r}")
    check(same_rows and unequal == 0,
          f"{tag}: the graphed steps differ from the eager steps")
    tr = check_step_replay(tag, graph["step"].graphs, graph["state"], batch,
                           GRAPH_STEPS)
    captured = tr["captured"]
    replay = replay_ms(captured.graph)
    lr = graph["step"].graphs.schedule(GRAPH_STEPS)
    t = time.perf_counter()
    for _ in range(GRAPH_SNAPSHOT_REPS):
        optimizer.host(graph["state"].opt, lr, captured.plan)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t) / GRAPH_SNAPSHOT_REPS * 1e6
    t = time.perf_counter()
    for _ in range(GRAPH_SNAPSHOT_REPS):
        _unchanged(captured.snap)
    snap_us = (time.perf_counter() - t) / GRAPH_SNAPSHOT_REPS * 1e6
    # steps 2 on: eager steps against replays
    wall_e = statistics.median(eager["walls"][2:]) * 1e3
    wall_g = statistics.median(graph["walls"][2:]) * 1e3
    dev_e, dev_g = tr["eager"]["device_ms"], tr["graph"]["device_ms"]
    nodes = sum(tr["nodes"].values())
    print(f"[{tag}] host wall per step (median of steps 2-{GRAPH_STEPS - 1},"
          f" host clock to a synchronize) eager {wall_e:.3f} ms -> graph "
          f"{wall_g:.3f} ms; a traced step's device time eager {dev_e:.3f} "
          f"ms, replay {dev_g:.3f} ms (busy share {dev_e / wall_e:.3f} -> "
          f"{dev_g / wall_g:.3f}); one replay alone between CUDA events "
          f"{replay:.3f} ms; peak memory over the run's base eager "
          f"{eager['peak']:.0f} MiB, graph {graph['peak']:.0f} MiB; the "
          f"optimizer's host part {host_us:.1f} us, the graph's model and "
          f"optimizer check {snap_us:.1f} us ({len(captured.snap)} entries)")
    print(f"[{tag}] the graph's kernel nodes, read from the graph, are the "
          f"library kernels of the eager step by name and count ({nodes}: "
          f"{json.dumps(dict(tr['nodes']))}); a traced replay launches one "
          f"graph and adds the eager step's launches")
    out = dict(wall_e=wall_e, wall_g=wall_g, dev_e=dev_e, dev_g=dev_g,
               replay=replay, peak_e=eager["peak"], peak_g=graph["peak"],
               host_us=host_us, snap_us=snap_us)
    del runs, eager, graph, tr, captured
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fused_lr_difference() -> dict:
    """``torch.optim.AdamW(fused=True)`` with the learning rate as a float
    (the kernel computes with it as a double) and as a 0-dim fp32 tensor on
    the card (as the port's update passes it, eager and graphed): three
    steps on the same parameters and gradients (8 tensors of 1024 x 4096,
    fp32; lr 1e-4, decay 0.05), the share of elements that differ and the
    largest difference, relative to the update's size."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9)
    params = [torch.randn((1024, 4096), generator=gen, device="cuda") * 0.02
              for _ in range(8)]
    grads = [[torch.randn_like(p) * 1e-3 for p in params] for _ in range(3)]
    out = {}
    for form in ("float", "tensor"):
        ps = [torch.nn.Parameter(p.clone()) for p in params]
        lr = 1e-4 if form == "float" else torch.tensor(
            1e-4, dtype=torch.float32, device="cuda")
        opt = torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.05, fused=True)
        for k in range(3):
            for p, g in zip(ps, grads[k]):
                p.grad = g
            opt.step()
        out[form] = [p.detach() for p in ps]
    diff = [(a - b).abs() for a, b in zip(out["float"], out["tensor"])]
    moved = max(float((a - p).abs().max()) for a, p in zip(out["float"],
                                                           params))
    n = sum(d.numel() for d in diff)
    share = sum(int((d > 0).sum()) for d in diff) / n
    worst = max(float(d.max()) for d in diff)
    print(f"[train_graphs] fused AdamW, lr as a float against a 0-dim fp32 "
          f"tensor on the card, 3 steps on {n} fp32 parameters: "
          f"{share:.4%} of the elements differ, by at most {worst:.3g} "
          f"({worst / moved:.3g} of the largest update, {moved:.3g})")
    return dict(share=share, worst=worst, moved=moved)


def phase_train_graphs(label: str) -> dict:
    """Path ``train_graphs``: the train step from captured CUDA graphs (the
    counterpart of the JAX drivers' ``jax.jit`` of ``make_train_step``)
    against the same steps run eagerly, bit for bit (graph_against_eager):
    ``train_bf16``'s recipe at full width and depth (B = 64) with fused
    AdamW and with bf16 moments (K18), ``rec19k``'s (its int8 encoder inside
    the graph) with both, and ``p128_train``'s 2 + 2 cut at B = 8 with both;
    each schedule switching at GRAPH_SWITCH. Returns the launch counts of
    the graph runs."""
    import torch

    from tae_tpu_torch import models
    from tae_tpu_torch.profile_training import WEIGHT_DECAY
    from tae_tpu_torch.train import (TrainState, adamw, make_train_step,
                                     step_lr)
    from tae_tpu_torch.train.losses import cross_entropy
    from tae_tpu_torch.utils.dtypes import Policy

    fused_lr_difference()
    totals: dict = {}
    policy = Policy()
    bf16 = torch.bfloat16

    def tae_recipe(name, moment_dtype, **cut):
        def build(mode):
            model = models.create(name, device="cuda", trainable=True, **cut)
            model.init_weights_(torch.Generator(device="cuda").manual_seed(0))
            opt = adamw(weight_decay=WEIGHT_DECAY, moment_dtype=moment_dtype)
            step = make_train_step(
                lambda m, b: (m(b, policy=policy)[0], {}), opt,
                step_lr(1e-4, 1e-5, GRAPH_SWITCH), cuda_graphs=mode)
            return TrainState.create(model, opt), step
        return build, adamw(weight_decay=WEIGHT_DECAY,
                            moment_dtype=moment_dtype)

    encoder = downstream_encoder("int8")

    def rec_recipe(moment_dtype):
        def build(mode):
            opt = adamw(weight_decay=0.0, moment_dtype=moment_dtype)
            model = models.create(REC_MODEL, num_classes=REC_CLASSES,
                                  device="cuda", trainable=True)
            model.init_weights_(torch.Generator(device="cuda").manual_seed(1))
            step = downstream_step(encoder, cross_entropy,
                                   step_lr(1e-4, 1e-5, GRAPH_SWITCH), 0.0,
                                   remat=True, moment_dtype=moment_dtype,
                                   cuda_graphs=mode)
            return TrainState.create(model, opt), step
        return build, adamw(weight_decay=0.0, moment_dtype=moment_dtype)

    gen = torch.Generator(device="cuda").manual_seed(3)
    p16_batch = torch.randn((TRAIN_BATCH, 3, 256, 256), generator=gen,
                            device="cuda")
    rec_batch = (torch.randn((REC_BATCH, 3, 256, 256), generator=gen,
                             device="cuda"),
                 torch.arange(REC_BATCH, device="cuda") * 2399 % REC_CLASSES)
    p128_batch = torch.randn((8, 3, 256, 256), generator=gen, device="cuda")
    p16_cfg = models.create(PATHS[0][0], device="meta").cfg
    p128_cfg = models.create(PATHS[1][0], device="meta",
                             depth=2, decoder_depth=2).cfg
    rec_cfg = models.create(REC_MODEL, num_classes=REC_CLASSES,
                            device="meta").cfg
    rec_want = summed(encoder_launches(encoder, "int8"),
                      trunk_launches(rec_cfg, remat=True))
    cases = [
        ("train_bf16", tae_recipe(PATHS[0][0], None), p16_batch,
         train_launches(p16_cfg)),
        ("train_bf16 bf16 moments", tae_recipe(PATHS[0][0], bf16), p16_batch,
         dict(train_launches(p16_cfg), adamw_update=1)),
        ("rec19k", rec_recipe(None), rec_batch, rec_want),
        ("rec19k bf16 moments", rec_recipe(bf16), rec_batch,
         dict(rec_want, adamw_update=1)),
        ("p128_train", tae_recipe(PATHS[1][0], None, depth=2,
                                  decoder_depth=2), p128_batch,
         train_launches(p128_cfg)),
        ("p128_train bf16 moments", tae_recipe(PATHS[1][0], bf16, depth=2,
                                               decoder_depth=2), p128_batch,
         dict(train_launches(p128_cfg), adamw_update=1)),
    ]
    results = {}
    for name, (build, optimizer), batch, want in cases:
        t = time.perf_counter()
        path_totals: dict = {}
        results[name] = graph_against_eager(f"train_graphs {name}", build,
                                            batch, want, path_totals,
                                            optimizer)
        for k, v in path_totals.items():
            totals[k] = totals.get(k, 0) + v
        print(f"[train_graphs] {name}: ({time.perf_counter() - t:.1f} s; "
              f"{label})")
    del encoder
    print(f"[train_graphs] main path launches: {json.dumps(totals)}")
    return totals


def driver_losses(module, argv: list, log: pathlib.Path | None = None
                  ) -> dict:
    """``module.main`` on ``argv``, a comparison's run (no graph checks;
    the counters put back after it): each train step's loss, read after
    the step (``losses``), the graphs its step and eval functions hold at
    the end (``held``), what ``main`` returned (``ret``), the rows it
    appended to the JSONL log ``log`` (``rows``), and its peak memory
    allocated and reserved over what was allocated before it (GiB; the
    cache emptied and the peaks reset first)."""
    import gc

    import torch

    fns = wrappers()
    saved = {n: f.launches for n, f in fns.items()}
    real = {name: getattr(module, name) for name in ("make_train_step",
                                                     "make_eval_fn")
            if hasattr(module, name)}
    losses, made = [], []

    def make_step(*a, **kw):
        step = real["make_train_step"](*a, **kw)
        made.append(step)

        def logged(state, batch, it):
            out = step(state, batch, it)
            losses.append(float(out[1]["loss"]))
            return out

        return logged

    def make_eval(*a, **kw):
        fn = real["make_eval_fn"](*a, **kw)
        made.append(fn)
        return fn

    for name, fn in (("make_train_step", make_step),
                     ("make_eval_fn", make_eval)):
        if name in real:
            setattr(module, name, fn)
    before = len(ds_rows(log)) if log is not None and log.exists() else 0
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        with graph_checks_off():
            ret = module.main(module.get_args_parser().parse_args(argv))
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)
        for n, f in fns.items():
            f.launches = saved[n]
    return dict(
        losses=losses, ret=ret,
        held=sum(len(m.graphs) for m in made if m.graphs is not None),
        rows=ds_rows(log)[before:] if log is not None else [],
        allocated=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        reserved=(torch.cuda.max_memory_reserved() - base) / 2 ** 30)


def graphs_off_against_default(tag: str, module, argv: list, steps: int,
                               log: pathlib.Path | None = None) -> dict:
    """A driver run by default (graphs on the card) and with --cuda_graphs
    off on the same arguments (inline loading: one batch order): ``steps``
    train steps each, each step's loss equal, and the JSONL rows appended
    to ``log`` (eval losses, accuracies, IoU) and what ``main`` returns
    equal; the peak memory of both runs printed. Returns both runs."""
    t = time.perf_counter()
    on = driver_losses(module, argv, log)
    off = driver_losses(module, argv + ["--cuda_graphs", "off"], log)
    name = module.__name__.rsplit(".", 1)[-1]
    print(f"[{tag}] {name} by default (graphs held at the end: {on['held']})"
          f" and with --cuda_graphs off ({off['held']}): step losses "
          f"{on['losses']} and {off['losses']}; log rows {on['rows']} and "
          f"{off['rows']}; main returned {on['ret']!r} and {off['ret']!r}; "
          f"equal: {on['losses'] == off['losses'] and on['rows'] == off['rows'] and on['ret'] == off['ret']}"
          f" ({time.perf_counter() - t:.1f} s)")
    print(f"[{tag}] {name} peak memory over the run's base, graphs / "
          f"--cuda_graphs off: allocated {on['allocated']:.2f} / "
          f"{off['allocated']:.2f} GiB, reserved {on['reserved']:.2f} / "
          f"{off['reserved']:.2f} GiB ({card_label()})")
    check(len(on["losses"]) == len(off["losses"]) == steps
          and on["held"] >= 1 and off["held"] == 0,
          f"{tag}: {len(on['losses'])} / {len(off['losses'])} steps, "
          f"{on['held']} / {off['held']} graphs")
    check(on["losses"] == off["losses"] and on["rows"] == off["rows"]
          and on["ret"] == off["ret"],
          f"{tag}: --cuda_graphs off gives other numbers")
    return {"on": on, "off": off}


START = time.perf_counter()


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds printed on a line of their own, after the
    graph checks it made (GRAPH_CHECKS), where it made any."""
    t = time.perf_counter()
    counts = {k: v for k, v in GRAPH_CHECKS.items() if k != "on"}
    out = fn(*args)
    made = {k: GRAPH_CHECKS[k] - v for k, v in counts.items()}
    if made["steps"] or made["evals"]:
        print(f"[{name}] graph checks: each of the {made['steps']} step "
              f"graphs and {made['evals']} eval graphs this phase captured "
              f"holds, read from the graph, the library kernels of its "
              f"key's eager call by name and count ({made['nodes']} kernel "
              f"nodes in all), and a traced replay adds the launches the "
              f"wrappers counted in that call ({made['lost']} lost traces "
              f"and {made['again']} eager traces disagreeing with the graph "
              f"taken again)")
    print(f"[time] {name}: {time.perf_counter() - t:.1f} s", flush=True)
    return out


def main() -> int:
    try:
        phase_device()
        repo = pathlib.Path(__file__).resolve().parent
        sys.path.insert(0, str(repo))
        try:
            import tae_tpu_torch  # noqa: F401
        except ImportError as e:
            raise SmokeFailure(f"cannot import tae_tpu_torch next to "
                               f"{pathlib.Path(__file__).name}: {e}") from e
        install_graph_checks()
        timed("build", phase_build)
        kres = timed("kernels", phase_kernels)
        kres.update(timed("int8_kernels", phase_int8_kernels))
        kres.update(timed("attention_kernels", phase_attention_kernels))
        kres.update(timed("train_kernels", phase_train_kernels))
        for name, cases in timed("downstream_kernels",
                                 phase_downstream_kernels,
                                 card_label()).items():
            kres[name] += cases
        kres.update(timed("int4_kernels", phase_int4_kernels))
        kres.update(timed("vq_kernel", phase_vq_kernel))
        last = timed("last_kernels", phase_last_kernels)
        kres["nearest_code"] += last.pop("nearest_code")
        kres.update(last)
        kres.update(timed("k18_kernel", phase_k18_kernel))
        launches = timed("paths", phase_paths)
        for tag in VQ_PATHS:
            launches[tag] = timed(tag, phase_vq, tag, launches["graphs"])
        launches[VQ_F32_PATH] = timed(VQ_F32_PATH, phase_vq_f32)
        launches[P128_F32_PATH] = timed(P128_F32_PATH, phase_p128_f32)
        launches[TRAIN_F32_PATH] = timed(TRAIN_F32_PATH, phase_train_f32)
        launches["qknorm_blocks"] = timed("qknorm_blocks", phase_qknorm, kres)
        launches["train_bf16"] = timed("train_bf16", phase_train, kres)
        launches["p128_train"] = timed("p128_train", phase_p128_train)
        label = card_label()
        launches["train_graphs"] = timed("train_graphs", phase_train_graphs,
                                         label)
        launches["train_p128_fsdp"] = timed("train_p128_fsdp",
                                            phase_train_p128_fsdp, label)
        timed("world2", phase_world2)
        launches["tensor2"] = timed("tensor2", phase_tensor2, label)
        launches["drivers"] = timed("drivers", phase_drivers)
        launches["convergence"] = timed("convergence", phase_convergence)
        launches["drivers_mesh"] = timed("drivers_mesh", phase_drivers_mesh)
        launches["rec19k"] = timed("rec19k", phase_rec19k, label)
        launches["seg_p16"] = timed("seg_p16", phase_seg_p16, label)
        launches["downstream"] = timed("downstream", phase_downstream_drivers,
                                       label)
        print(f"[time] all phases: {time.perf_counter() - START:.1f} s")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()

    import torch

    def old_style(cases, main, lib_case):
        """K1/K2 case tuples -> the record of the main-path shape."""
        c = next(c for c in cases if main(c))
        return dict(max_abs_err=max(c[1] for c in cases), ms=c[2],
                    plain_ms=c[3], bound_ms=c[-2][0], bound_by=c[-2][1],
                    library_ms=next(c for c in cases if lib_case(c))[-1])

    def slice_shape(c):
        return c[0] == torch.bfloat16 and c[4] == 256

    records = {
        "fused_layer_norm": old_style(kres["fused_layer_norm"],
                                      lambda c: c[0] == torch.bfloat16,
                                      lambda c: c[0] == torch.bfloat16),
        # the library call has no clamped softmax: its time is the exact form's
        "fused_qkv_attention": old_style(
            kres["fused_qkv_attention"], lambda c: slice_shape(c) and c[5],
            lambda c: slice_shape(c) and not c[5]),
    }
    for name in [k["name"] for k in KERNELS[2:]]:
        cases = kres[name]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        records[name] = dict({k: cases[0][k] for k in keys},
                             max_abs_err=max(c["max_abs_err"] for c in cases),
                             cases=cases)
    # K6's library call has only the exact softmax: the time at the same shape
    k6 = kres[K6["name"]]
    records[K6["name"]]["library_ms"] = next(
        c["library_ms"] for c in k6 if c["library_ms"] is not None)
    # the training forwards: K1's, K2's and K16's numbers with one more
    # output; K4's int8_matmul_rows entry (q8_out, in-kernel quantize)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for forms, key in ((TRAIN_FORMS, "training_form"), (ROW_FORMS, "rows_form")):
        for name, form in forms.items():
            records[name][key] = dict(
                {k: kres[form][0][k] for k in keys}, name=form,
                cases=kres[form])
    # the fp32 forms of the attention entries, redesigned for the card on
    # the CUDA cores: the first timed fp32 case is the main fp32 shape
    f32_paths = {K6["name"]: P128_F32_PATH, K9["name"]: P128_F32_PATH,
                 K10["name"]: TRAIN_F32_PATH}
    for name in (K6["name"], K7["name"], K8["name"], K9["name"], K10["name"],
                 K17["name"]):
        cases = [c for c in kres[name]
                 if "fp32" in c["case"] or "float32" in c["case"]]
        main_case = next(c for c in cases if c["ms"] is not None)
        records[name]["fp32_form"] = dict(
            {k: main_case[k] for k in keys}, case=main_case["case"],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            yardstick_ms=main_case.get("k2_quantize_ms"),
            launches=launches.get(f32_paths.get(name), {}).get(name, 0))
    # ids have no absolute error: K14's figure is the share of rows whose id
    # differs from the plain version's (near-ties, bounded in compare_ids)
    records[K14["name"]]["max_abs_err_is"] = "share of rows with another id"
    kernels = []
    for meta in KERNELS:
        name = meta["name"]
        # a train path launches K1, K2 and K16 in their training forms, the
        # qkv_q8 path K4 through int8_matmul_rows
        by_path = {path: counts.get(name, 0)
                   + counts.get(TRAIN_FORMS.get(name), 0)
                   + counts.get(ROW_FORMS.get(name), 0)
                   for path, counts in launches.items()}
        kernels.append(dict(meta, launches=sum(by_path.values()),
                            launches_by_path=by_path, **records[name]))
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        print(f"FAIL: no path launched {idle}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
