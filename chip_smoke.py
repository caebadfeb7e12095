#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Builds every hand-written kernel from ``unet_zoo_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, all in parallel).
3. Holds K1 (``fused_up_concat_conv``) against its plain PyTorch version at
   the four served 256px ``unet`` decoder-stage shapes (B=8) and the edge
   cases (non-square, Co != Cu, ragged tiles, Cu = Cs = 32, Cu 96, B = 1):
   the error beyond one bf16 ulp as a share of the output's rms, two
   launches bit for bit, four planted faults rejected (a halo one pixel
   short, dx and dy swapped, the up|skip boundary off by one chunk, bt
   dropped), and the plan's ring against the source's.
4. Serves full-width ``unet`` in bf16 through ``make_predictor`` at B=8,
   256x256, on the kernel path and on the plain module path (same seeded
   weights): compares them, confirms with ``torch.profiler`` that K1 ran on
   all four decoder stages, and times both paths and each stage.
5. Holds K4 (``fused_mkblock``) and K5 (``fused_softmax_morph``) against
   their plain versions at every distinct full-width ``mmunet`` shape and
   one odd shape each (K4: and the edges of its forms), each comparison
   scaled to what the output computes
   and shown to reject planted faults (K4: the cascade padded with gelu(t)
   instead of zero; K5: zero outputs, the wrong window, erosion padded
   with 0, the second round padded with 0 or with the pads swapped, the
   kernel launched with a strip or band halo one pixel short); K5 also
   launches twice bit for bit and its source's geometry is the plan's.
6. Serves full-width ``mmunet`` (base 96, bf16, B=8, 256x256) the same way:
   K4 must run on all 22 MKBlocks and K5 on all 6 morphology gates, by the
   launch counters and by the profiler (each K5 launch both its grids); times both paths, and K4 and K5 at
   every launch shape against their plain versions and the bf16 module
   chains they replace, with each K4 and K5 grid's device time from the
   profiler.
7. Holds K6 (``fused_axial_attention``) against its plain version at every
   launch shape of the full-width ``gated`` forward, on both axes, in
   ``wopos`` mode at two shapes, at an odd shape whose axis is shorter
   than the kernel size, at L = 33, 127 and 129 (partial key tiles) and
   at every gp at L = 128; each comparison is shown to reject planted
   faults (the k embedding read untransposed, the softmax over queries, the
   sve term dropped) and, through the source's test-only entry, faults of
   the kernel's design where they apply (the rescale skipped when a row's
   reference moves, the last partial key tile dropped, the key splits'
   merge dropped); every case launches twice bit for bit.
8. Serves full-width ``gated`` (bf16, B=8, 256x256) on both paths: K6 must
   run 16 times per forward, by the launch counter and by the profiler
   (every K6 grid name); times both paths and K6 at every launch shape
   against its bound, its plain version and the bf16 module chain it
   replaces, by CUDA events and by CUDA graph. Serves
   ``axialunet``, ``medt``, ``logo`` and ``medt_logo`` at B=2, 128x128 on
   both paths, compared the same way. Each model is also served in float32
   on the kernel path against float32 compute, and with faults planted
   into K6's arguments (q and k swapped, the k embedding untransposed, the
   sve term dropped), which the served-model checks must reject.
9. Holds K7 (``fused_axial_train``: stats, fwd, bwd, fin, combine) against
   its plain version, forward and backward (13 outputs), at every launch
   shape of the B=8 ``gated`` train step on both axes, at gp 32 with L = 128
   and at N = 37, L = 29 < ks = 40; each comparison is shown to reject
   planted faults (the combine without the e x̂ term, var without -mu^2,
   d_relative from one bwd block per group, kr reading the k embedding
   untransposed).
10. Trains full-width ``gated`` (bf16 compute, float32 parameters, B=8,
   256x256) through ``make_train_step`` on the kernel path and on the module
   path from the same weights and batch: each of K7's five grids runs 16 times per
   step, by the launch counters and by the profiler; gradients and running
   statistics of the two paths compared; the loss must fall over 10 steps
   on both; train img/s, peak memory, device busy time; every K7 launch of
   one step from the seeded weights (a fresh copy of the model, so the
   recorded state is the same in every run) held against the plain version
   on the model's own operands and incoming gradients; every axis pass of
   that step run again on its own operands and a seeded incoming gradient,
   the train kernel chain and the bf16 module chain each held against the
   float32 module chain (outputs, gradients, running
   statistics), with planted faults that must fail. Where the whole
   model's bf16 gradient stands: float32 on bf16-rounded weights and both
   bf16 paths against float32, at registry depth and at layers (1, 1, 1,
   1) (reported). ``axialunet`` trains 3 steps at B=2/128px. K7 timed per
   launch shape, forward and backward, by CUDA graph replay (device time) and
   through autograd (CUDA events, what a step sees), against its bound, its
   plain version, the module chain it replaces and the train kernel chain.
11. Holds K2 (``swin_window_attention``) against its plain version at every
   launch shape of both served ``swin_unet_v2`` configurations (224px with
   window 7, 256px with window 8: N 49 and 64, nW 64/16/4 and unshifted),
   all on its mma instance, and at odd shapes (B_ = 6 with hd 16 and N 36
   on the mma instance; N 100 and a served shape in float32 on the general
   one), with tau below its 0.01 clip, a bias of a few units and an
   all-zero q row and k row; each comparison is shown to reject planted
   faults (the bias table transposed, the mask read by image, tau
   unclipped, the softmax over queries and, on the mma instance through the
   source's test-only entry, a block's windows given one mask index and P
   rounded once to bf16); the mma plan's numbers are held against the
   source's and ``HMMA`` is counted in the built library.
12. Serves full-width ``swin_unet_v2`` (registry defaults, bf16, B=8) in
   both configurations on both paths, tau and the CPB bias sharpened alike
   on both: K2 must run 14 times per forward on its mma instance, by the
   launch counters and by the profiler; every K2 launch of the served
   forward is held against its plain version on the model's own operands,
   and faults planted into K2's arguments (q and k swapped, the bias
   transposed, the mask read by image) must fail; times both paths and K2
   at every launch shape, by CUDA events and by CUDA graph, against its
   bound, its plain version and the bf16 module chain it replaces.
13. Holds K3 (``depthwise_conv2d``) against its plain version at every
   distinct launch shape of ``unext`` and ``unext_s`` (B=8, 256px) and an odd
   shape (odd H and W, C 24), all on its stream instance, and at two odd
   shapes of its general instance (C 20, k 5; float32), each launched twice
   bit for bit; each comparison is shown to reject planted faults (the taps
   transposed, the halo read one pixel into the neighbouring tile or band,
   the bias dropped, and on the stream instance the source's own: a band's
   halo rows from the neighbouring band, a stale ring slot).
14. Serves ``unext`` and ``unext_s`` (registry defaults, bf16, B=8, 256px) on
   both paths: K3 must run 13 and 6 times per forward on its stream
   instance, by the launch counters and by the profiler; every K3 launch of
   the served forward is held against its plain version on the model's own
   operands; times both paths and K3 at every launch shape (by CUDA graph,
   by events and the wrapper's host time a call) against its bound, its
   plain version, the bf16 module chain it replaces and cuDNN's depthwise
   conv.
15. Holds K8 (``deform_conv2d``) against its plain version at both ``wranet``
   launch shapes, an odd shape (C 40, O 24), C not a multiple of 8, O 128, a
   7x7 kernel, stride 2 and dilation 2, each with offsets of std 0, 1, 3 and
   8 pixels (at 3 and 8 past every edge of the frame) and sigmoid masks;
   every case launches twice bit for bit, and each comparison is shown to
   reject planted faults (corner weights' x and y swapped, no clamp to the
   frame, the mask ignored, taps in column-major order, and, through the
   source's test-only variant, each tap's row tile multiplied by the next
   tap's weights).
16. Serves ``wranet`` (feature_channels 128, bf16, B=8, 256px) on both paths
   with the offset and modulator convs drawn alike off their zero init: K8
   must run twice per forward, by the counter and by the profiler; every K8
   launch held against its plain version on the model's operands (and the
   design fault on the same operands must fail); times both paths and K8 at
   both launch shapes by CUDA graph and by events against its bound, the
   exact blend's issue floor, its plain version and the bf16 module chain it
   replaces.
17. Holds P2's int8 conv (``int8_conv3x3``, the implicit-GEMM int8 conv of
   int8 serving, which quantises its float x as it loads it) against its
   plain version, bit for bit, at every launch shape of the served
   ``unet_tpu`` (bf16 x) and ``unet`` (float32 x), split K included, and at
   odd shapes (Ci 3 and 20, odd H and W, stride 2 on an odd size), with x on
   exact half-way points of x / s_x and beyond +-127 s_x; each comparison is
   shown to reject planted faults (the taps transposed, the stride ignored,
   a per-tensor weight scale, the bias dropped, ties rounded away from 0).
18. Calibrates and serves ``unet_tpu`` (registry widths, bf16, bf16-rounded
   weights) and ``unet`` (float32, the README's int8 recipe) at B=8, 256px
   three ways: float, int8 on the kernel path, int8 on the plain path. The
   int8 conv must run 17 and 18 times per forward and K1 never, by counter
   and by profiler; every int8 launch of the served forward is held against
   its plain version; the paths' logits and masks, and int8 against float
   (JAX's bars); img/s, device-time breakdowns, and the int8 conv at every
   launch shape against its bound, its plain version and cuDNN's bf16 conv.
   The int8 kernel path's profiled forward must hold no round kernel and no
   more divide or clamp kernels than the float path's: x is quantised inside
   P2's conv.
19. P2's GEMM at 4096^3 on its probe's path: s8 bit for bit against
   ``torch._int_mm``, bf16 against float32, and at ragged shapes with K 64,
   128 and 4096; rates against the bounds and the library calls, and the
   int8/bf16 ratio. The built P2 library must hold wgmma instructions
   (``IGMMA`` and ``HGMMA`` in ``cuobjdump -sass``).
20. P1's row gather at its probe's shape, bit for bit against
   ``index_select``, timed by CUDA graph replay against its bytes bound.
21. Trains full-width ``unet`` (bf16 compute on float32 parameters, B=8,
   256x256, uint8 blob images with on-device flips) through the training
   loop (``train/loop.py::train_model``) for 2 epochs, then resumes from the
   last checkpoint for a third: the restored weights, AdamW state, step,
   learning rate, scheduler and early stopping must equal what was saved,
   bit for bit; every validation batch must run K1 on all four decoder
   stages (by counter and by profiler); each epoch's validation through K1
   must agree with the same validation on the plain module path; the train
   loss must fall from epoch 1 to 3; the best and last checkpoints must
   exist; ``evaluate_model`` runs on the best. ``gated`` trains one epoch of
   4 steps through the same loop: K7 in every step, K6 in every validation
   batch, both counted. Logs train and validation img/s, epoch seconds and
   peak memory.
22. Serves the BASELINE core members and the names that share their blocks
   (``attention_unet``, ``nested_unet`` with deep supervision, ``u2net``,
   ``u2netp``, ``resunet``, ``u2net_tpu``) at registry defaults in bf16
   through ``make_predictor`` at B=8, 256px: every output key finite and of
   the input's size, the logits within 3e-2 rel L2 and the masks within 0.99
   of float32 compute on the same bf16-rounded weights; img/s, device busy
   and idle share, peak memory. Trains ``u2net`` and ``nested_unet`` for 5
   steps each through ``make_train_step`` (the loss must fall with every
   output key at its spec's weight; train img/s, peak memory). Calibrates and
   serves ``attention_unet`` int8 in bf16 as step 18 serves ``unet_tpu``: P2's
   conv 22 times a forward by counter and by profiler, every launch bit for
   bit against its plain version, int8 against float within rel L2 0.19
   (these random weights put JAX's own int8 forward above its 0.10 bar: see
   ``INT8_FLOAT_BARS``) and JAX's 0.95 on masks, and the conv at each launch
   shape against its bound.
23. Holds K3 against its plain version, with the planted faults of step 13,
   at every launch shape that ``missformer`` (512px and 256px) and
   ``unext_moe`` (256px) add at B=8: bands of 1 and 2 rows at the bridge's
   8x8 and 16x16 tokens, 64 rows at 512px's first stage. Serves
   ``missformer`` (registry defaults, bf16, B=8) at 512px and 256px and
   ``unext_moe`` at 256px on both paths as step 14 serves ``unext``: 32 and
   3 K3 launches a forward on its stream instance by counter and by
   profiler, each against its plain version on its own operands; the
   logits and masks against the plain path, each path's distance to float32
   compute; img/s, busy, idle share, peak memory; each MoE block's share of
   tokens dropped at capacity. Times K3 at every launch shape of the three
   forwards. Trains ``missformer`` and ``unext_moe`` at 256px for 5 steps
   through ``make_train_step``: the loss falls, K3 never launches, and
   ``unext_moe``'s load-balancing terms are finite and in the loss.
24. The convolutional members: serves ``raunet`` (its encoder from the
   vendored synthetic-pretrained file, the load timed), ``transatt_unet``
   (PAM's gamma drawn off zero), ``unet_transformer``, ``multiresunet`` and
   ``vnet`` at registry defaults in bf16 at B=8, 256px as step 22 serves its
   members (no kernel launches; the same bars). Trains each for 5 steps
   through ``make_train_step`` at the default training config's learning
   rate (the loss falls with every key at its spec's weight; vnet's and
   transatt_unet's dropout drawn alike at every step). Calibrates and serves
   ``transatt_unet`` and ``unet_transformer`` int8 in bf16 as step 18 serves
   ``unet_tpu``: P2's conv 18 and 14 times a forward by counter and by
   profiler, every launch bit for bit against its plain version, int8
   against float within JAX's bars, and the conv at every launch shape
   against its bound and cuDNN's bf16 conv.
25. Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
   as the last line.

Steps 17-20, with step 22's int8 ``attention_unet`` and step 24's int8
``transatt_unet`` and ``unet_transformer``, run right after step 4.

Any failed check raises, so the script exits non-zero and prints no result.
It needs CUDA and the repository; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import zlib

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
H100_SMS, SM_LANES, SM_CLOCK_HZ = 132, 128, 1.98e9   # issue: 4 warp-instructions a clock an SM
SERVE_BATCH = 8
IMAGE = 256
# y [B, Cin, Hc, Wc] and skip [B, Cs, 2Hc, 2Wc] of unet's four decoder
# stages at 256px (Co = Cu = Cin / 2 = Cs)
STAGES = [(1024, 512, 16), (512, 256, 32), (256, 128, 64), (128, 64, 128)]
# mmunet (base 96) at 256px: (C, H=W, MKBlocks of that shape per forward)
MKBLOCK_SHAPES = [(96, 256, 4), (192, 128, 2), (192, 64, 4), (384, 32, 2), (768, 16, 2),
                  (768, 8, 2), (384, 16, 2), (192, 32, 2), (96, 128, 2)]
# (C, H=W, repeat, gates of that shape per forward): the four Up gates, the EFM pair
MORPH_SHAPES = [(768, 16, 2, 1), (384, 32, 2, 1), (192, 64, 2, 1), (192, 128, 2, 1),
                (96, 256, 1, 2)]
# kernel path vs plain path, relative L2 of mmunet logits. Both are bf16, but
# they round in different places through 22 residual blocks: the plain path
# rounds each of a block's ~15 ATen results, the kernel path keeps the
# depthwise cascade in f32 and rounds h0 and the hidden layer (measured
# 1.12e-2 at B=8/256px, H100; see PERF.md).
MMUNET_REL_L2 = 3e-2
# K4 against its plain version: the error beyond the output's bf16 rounding,
# as a share of the rms of the MLP branch (see k4_reading). Measured at most
# 2.7e-3 on the H100 at the full-width shapes and the edge cases (h0 agrees
# bit for bit, so the MLP's roundings alone remain); the planted border
# fault (mkblock_border_fault) reads 8.4e-2 or more there (PERF.md).
K4_BRANCH_SHARE = 2e-2
# K4 beyond mmunet's shapes, at the edges of its forms (ops/kernels/mkblock.py::plan):
# H, W not multiples of 8 or of the 16-pixel cascade tile; M below one
# 128-row MLP tile; M one more than a whole persistent wave of 132 tiles
# (61 x 277 = 132 x 128 + 1) for the resident (96) and streamed (192) fused
# form; C = 384 and 768 at M = 512 (the split second GEMM); C = 160, a
# multiple of 32 outside mmunet's widths (a 64-byte-swizzled K box).
K4_EDGE_CASES = [(1, 32, 37, 29), (1, 96, 5, 7), (1, 96, 61, 277), (1, 192, 61, 277),
                 (8, 384, 8, 8), (8, 768, 8, 8), (2, 160, 12, 20)]
# K5 against its plain version, relative: half a bf16 ulp (2^-8) plus f32
# differences of exp and of the sum over C (see k5_reading).
K5_REL = 2.0 ** -8 + 2.0 ** -16
# gated at 256px: (H = W of the blocks, gp, kernel size, AxialBlocks of that
# shape); every block runs K6 twice, along H and along W (layer1_0, layer2_0,
# layer2_1, layer3_0, layer3_1..3, layer4_0)
AXIAL_SHAPES = [(128, 2, 128, 1), (128, 4, 128, 1), (64, 4, 64, 1), (64, 8, 64, 1),
                (32, 8, 32, 3), (32, 16, 32, 1)]
AXIAL_GROUPS = 8
# K6 against its plain version: the error beyond the output's bf16 rounding
# (half an ulp, 2^-8 |ref|), as a share of the output's rms (see k6_reading).
# What remains is f32 arithmetic in another order (sums over j, expf); the
# planted faults read orders of magnitude above the limit.
K6_SHARE = 1e-3
# the names of K6's grids (csrc/axial_attention.cu: one grid a launch)
K6_GRIDS = ("axial_attention_kernel",)
# K6's design faults (ops/kernels/axial_attention.py::FAULTS) are planted on
# the case's operands with the similarity scaled by K6_SHARPEN, so that rows'
# softmax references move; the served kernel is held on the same operands.
K6_SHARPEN = 6.0
# MedT, kernel path vs plain path: relative L2 of logits and mask agreement.
# Both paths are bf16 and round in different places: the plain path rounds
# the similarity logits, the softmax and every BN to bf16, the kernel keeps
# them in f32. Measured on the H100 (PERF.md): gated at B=8/256px 6.8e-3 and
# 0.99982; the B=2/128px forwards up to 5.1e-2 (medt) and 0.9913, where the
# kernel path lay closer to f32 compute than the plain path (4.1e-2 against
# 5.5e-2). So each run also holds the kernel path's distance to f32 compute
# to at most MEDT_F32_RATIO times the plain path's. These limits on logits
# do not part K6's rounding from a small fault (gated's planted untransposed
# k embedding passes all three); medt_faults holds every K6 launch of the
# served forward against its plain version, which rejects every fault.
MEDT_REL_L2 = {"gated": 2e-2, "small": 1e-1}
MEDT_AGREE = 0.99
MEDT_F32_RATIO = 1.25
# the 128px names (B=2) decide on the medians over MEDT_INPUTS seeded inputs
# (medt_bars), as probes/medt_paths.py reads them; medt_faults' "none" row
# adds every K6 launch of the forward (none_row_failed), and one input's
# readings are only logged.
# The kernel path's masks may agree with f32 compute's less than the plain
# path's by at most MEDT_F32_AGREE_SLACK (the probe read means of 0.99220
# and 0.99182 for medt on the H100, PERF.md).
MEDT_INPUTS = 32
MEDT_F32_AGREE_SLACK = 0.005
# one K6 launch per AxialAttention: two per AxialBlock (8 blocks; LoGo's
# global branch 3 and local branch 8)
MEDT_LAUNCHES = {"gated": 2 * sum(n for *_, n in AXIAL_SHAPES), "axialunet": 16, "medt": 16,
                 "logo": 16, "medt_logo": 22}
# K7 against its plain version (float32 on the same bf16 operands): every
# output's error beyond its own rounding (2^-8 |ref| for the bf16 outputs sv,
# sve, d_q, d_k, d_qg, d_kg, d_v; none for the float32 mu, var, d_relative,
# d_gamma), as a share of the output's rms (see k7_readings). What remains is
# float32 arithmetic in another order; the planted faults read far above.
K7_SHARE = 1e-3
K7_OUTPUTS = ("sv", "sve", "mu", "var", "d_q", "d_k", "d_qg", "d_kg", "d_v", "d_q_emb",
              "d_k_emb", "d_v_emb", "d_gamma")
# K7's five grids (two forward, three backward), each launched once per
# positional axis pass of a train step
K7_GRIDS = ("axial_train_stats", "axial_train_fwd", "axial_train_bwd", "axial_train_fin",
            "axial_train_combine")
TRAIN_STEPS = 10
# An axis pass of a step from the seeded weights run again on its own bf16
# operands and incoming gradient (check_train_blocks): the parameters whose
# gradients are read. bn_similarity.bias has an exactly zero gradient (softmax
# shift invariance). The gates' gradients are zero but for BatchNorm's eps, and so
# are bn_qkv.weight's on the v channels, and at gp 2 on all of them: each
# scales channels whose scale a train-mode BatchNorm normalises away. Their
# bf16 and float32 readings are both noise, so they are left out.
BLOCK_PARAMS = ("relative", "bn_qkv.bias", "bn_similarity.weight", "bn_output.weight",
                "bn_output.bias")
TRAIN_BLOCK_REL_L2 = 5e-2
# swin_unet_v2 served at full width (registry defaults, heads (3, 6, 12, 24),
# hd 32): (image, window) of the registry default and of the YAML configs
SWIN_CONFIGS = [(224, 7), (256, 8)]
# one K2 launch per SwinBlockV2: 8 encoder and 6 decoder blocks, each a grid
# of the mma instance
SWIN_LAUNCHES = 14
K2_GRID = "window_attention_mma_kernel"
# K2 against its plain version: the error beyond the output's bf16 rounding
# as a share of the output's rms (k6_reading, the K6 rule)
K2_SHARE = 1e-3
# swin_unet_v2 with sharpened attention, kernel path vs plain path: relative
# L2 of the logits, mask agreement, and the kernel path's distance to f32
# compute at most SWIN_F32_RATIO times the plain path's. The plain path
# rounds P to bf16 before P.V and computes the CPB table in bf16; K2 keeps
# both in f32. Measured on the H100 (PERF.md): 1.107e-2 and 1.173e-2 at
# 224px and 256px, masks 0.9965, distances to f32 0.88 and 0.85 of the
# plain path's; the faults planted into K2's arguments read 0.59 or more.
SWIN_REL_L2 = 3e-2
SWIN_AGREE = 0.99
SWIN_F32_RATIO = 1.25
# tau of the served comparison, drawn uniformly (init: 1), and the sharper
# draw whose paths are only reported: with cosines over tau down to 0.005 the
# attention is near one-hot, and bf16 rounding flips its choices on either
# path (PERF.md)
SWIN_TAU = (0.1, 1.0)
SWIN_TAU_SHARPER = (0.005, 0.1)
# unext / unext_s served at registry widths (B=8, 256px): embed dims and the
# three stage depths; one K3 launch per MiT block, on the hidden width 4 x dim
UNEXT_CONFIGS = {"unext": ((128, 160, 256), (3, 4, 6)), "unext_s": ((64, 128, 160), (2, 2, 2))}
UNEXT_LAUNCHES = {name: sum(depths) for name, (_, depths) in UNEXT_CONFIGS.items()}
# K3 and K8 against their plain versions on the same bf16 operands, both
# rounded to bf16 once: the error beyond one bf16 ulp (2^-7 |ref|) as a share
# of the output's rms (ulp_reading). What remains is f32 arithmetic in another
# order; the planted faults read orders of magnitude above.
K3_SHARE = 1e-3
K8_SHARE = 1e-3
# K1's two grids, each against its half of the plain version in f32 on the
# same bf16 operands (the ConvT's up against convt_reference, the conv's
# output against conv_reference on the kernel's own up; each rounded to
# bf16 once), read as ulp_reading, at the served stage shapes and
# K1_EDGE_CASES. The whole against the plain version: up rounds a few
# elements the other way (f32 sums in another order), and each such flip
# moves the outputs it feeds by up to ~1e-3 absolute, above one ulp of an
# output near zero; so the whole keeps the parent's bar, max abs error at
# most 1e-2 (1 + max |ref|) against the plain version in f32 (up unrounded).
# (B, Cin, Cu, Cs, Co, Hc, Wc)
K1_SHARE = 1e-3
K1_EDGE_CASES = [(1, 96, 64, 32, 48, 8, 12),     # non-square, Co != Cu, B = 1
                 (3, 64, 32, 32, 40, 5, 7),      # ragged M and N tiles
                 (1, 64, 32, 32, 16, 4, 6),      # Cu = Cs = 32: chunks past each source
                 (2, 160, 96, 64, 96, 9, 13),    # Cu 96, odd coarse sizes
                 (1, 32, 32, 32, 8, 3, 2)]       # 16 x 8 tiles, Co 8
# unext, kernel path vs plain path: relative L2 of the logits, mask agreement,
# and the kernel path's distance to f32 compute at most UNEXT_F32_RATIO times
# the plain path's. The paths differ only in the depthwise conv (K3 against
# cuDNN's bf16 grouped conv), each rounding the f32 sums once: measured 0 (the
# logits agree bit for bit) on the H100 (PERF.md); the limit leaves room for
# a sum rounded the other way.
UNEXT_REL_L2 = 1e-2
UNEXT_AGREE = 0.99
UNEXT_F32_RATIO = 1.25
# wranet (feature_channels 128) at 256px: K8 in decoder_lv2 at 128x128 and
# decoder_lv1 at 256x256, C 128 -> O 32, k 3
WRANET_FC = 128
WRANET_LAUNCHES = 2
# wranet, kernel path vs plain path: the module path rounds the corner weights
# to bf16, K8 keeps them in f32. Measured 1.110e-2, masks 0.99605, both paths
# 0.212 from f32 compute on the H100 (PERF.md)
WRANET_REL_L2 = 3e-2
WRANET_AGREE = 0.99
WRANET_F32_RATIO = 1.25
# the offset and modulator convs of every served wranet, drawn off their zero
# init from one seed (std = scale / sqrt(fan_in)), so that offsets reach a
# few pixels and masks spread over (0, 1) (draw_deform_offsets)
WRANET_OFFSET_SCALE = 2.0
WRANET_MASK_SCALE = 1.5
# int8 serving: unet_tpu at the registry widths (17 gated convs) in
# bf16 with bf16-rounded weights, as bench.py times it; unet (18 gated convs)
# in float32 with float32 weights, the README's recipe, where K1 stays off
# (float32 activations), so the kernel and the plain path quantise the same
# convs.
UNET_TPU_WIDTHS = (128, 256, 512, 512)
INT8_LAUNCHES = {"unet_tpu": 17, "unet": 18, "attention_unet": 22, "transatt_unet": 18,
                 "unet_transformer": 14}
# the int8 models served in bf16 with bf16-rounded weights (unet: float32);
# attention_unet (registry depth 5) is phase 22's, run with 17-20; its 22
# gated convs: 10 in the encoder, 4 after the nearest 2x upsamplings, 8 in
# the decoder. transatt_unet and unet_transformer are phase 24's, run with
# 17-20 too: the double convs of the encoder (5 and 4) and of the decoder
# (4 and 3)
INT8_BF16 = ("unet_tpu", "attention_unet", "transatt_unet", "unet_transformer")
# int8 kernel path against the int8 plain path (the same integer sums and
# epilogue: expected bit for bit), and int8 against the float predictor of
# the same type: JAX's own bars (tests/test_quant.py:57-60)
INT8_PATHS_REL_L2, INT8_PATHS_AGREE = 1e-3, 0.99
INT8_FLOAT_REL_L2, INT8_FLOAT_AGREE = 0.10, 0.95
# random-weight attention_unet reads above JAX's rel L2 bar on JAX's own side:
# JAX's int8 logits of the same seed-0 weights lie 0.126 from its float ones
# at 64px, masks 0.960, and further at larger images (0.100 at 32px); the
# port's within 1.25 times that. Its bar is at least 1.5 times JAX's 64px
# distance, its mask bar JAX's (tests/test_torch_core_members.py::
# test_int8_attention_unet_strays_from_float_as_far_as_jax holds both)
INT8_FLOAT_BARS = {"attention_unet": (0.19, INT8_FLOAT_AGREE)}
# P2's GEMM at the probe's default shape and tile, P1's gather at its probe's shape
GEMM_SIZE = 4096
GEMM_TILE = (128, 256)
GATHER_ROWS, GATHER_C, GATHER_N = 4096, 128, 4096
# the training loop (train/loop.py::train_model) at full width: unet in bf16
# on float32 parameters at B=8/256px over uint8 blob images (LOOP_TRAIN train,
# LOOP_VALID valid) with on-device flips, 2 epochs, then resumed for a third;
# gated for LOOP_GATED_STEPS steps. The default training config's schedule
# but for the patiences (1 and 2, so that a short run moves them) and the rate.
LOOP_TRAIN, LOOP_VALID, LOOP_GATED_STEPS = 64, 16, 4
LOOP_TRAINING = {"batch_size": SERVE_BATCH, "learning_rate": 1e-3, "early_stopping_patience": 2,
                 "lr_scheduler_patience": 1, "lr_scheduler_factor": 0.2, "min_lr": 1e-7,
                 "num_classes": 1, "seed": 0}
# each epoch's validation through K1 against the same validation on the plain
# module path, same weights and batches: loss relative, Dice absolute
LOOP_VAL_REL, LOOP_DICE_ABS = 1e-2, 1e-2
# phase 22: the BASELINE core members and the names that share their blocks,
# served at registry defaults in bf16 (B=8, 256px), each against float32
# compute on the same bf16-rounded weights (logits rel L2, mask agreement),
# and two of them trained for CORE_TRAIN_STEPS steps
CORE_MEMBERS = {"attention_unet": {}, "nested_unet": {"deep_supervision": True}, "u2net": {},
                "u2netp": {}, "resunet": {}, "u2net_tpu": {}}
CORE_REL_L2, CORE_AGREE = 3e-2, 0.99
CORE_TRAIN, CORE_TRAIN_STEPS = ("u2net", "nested_unet"), 5
# the keys their loss must weigh, at the JAX registry's weights: U2NET's unit
# side weights, nested_unet's sides at the default 0.5
CORE_LOSS_WEIGHTS = {"u2net": {"main": 1.0, **{f"side{i}": 1.0 for i in range(1, 7)}},
                     "nested_unet": {"main": 1.0, "side1": 0.5, "side2": 0.5, "side3": 0.5}}
# phase 23: the K3 carriers of this slice, in bf16 at B=8. missformer at 512px
# (the registry default) and 256px: one K3 launch per MixFFN_skip, on 4 x the
# stage width at each stage's resolution image / 2^(s + 2) in the encoder's
# and the decoder's two blocks a stage, and on 4 x 64 at every scale in each
# of the bridge's four layers (32 a forward). unext_moe at 256px: unext_s with
# the second MiT block of each stage a Switch-MoE (no depthwise conv): 3.
MISSFORMER_IMAGES = (512, 256)
MISSFORMER_DIMS = (64, 128, 320, 512)
MISSFORMER_LAUNCHES = 32
UNEXT_MOE_DIMS = (64, 128, 160)
UNEXT_MOE_LAUNCHES = 3
# missformer, kernel path vs plain path: the paths differ only in the
# depthwise conv (K3 against cuDNN's bf16 grouped conv, each rounding the f32
# sums once), but 32 of them feed LayerNorms, attention and GELUs through 12
# transformer layers of random weights; the kernel path within 1.25 times the
# plain path's distance to f32 compute. unext_moe keeps unext's bars.
MISSFORMER_REL_L2, MISSFORMER_AGREE, MISSFORMER_F32_RATIO = 3e-2, 0.99, 1.25
# both trained CORE_TRAIN_STEPS steps at the default training config's learning rate (1e-4):
# at 1e-3 the unext family's loss swings up tenfold in the first steps from
# random weights (unext_s as unext_moe: 1.7 -> 23.4 -> 5.4 in float32)
CARRIER_LR = 1e-4
# phase 24: the convolutional members at registry defaults, served in bf16
# (B=8, 256px) against float32 compute at phase 22's bars and trained
# CORE_TRAIN_STEPS steps at the default training config's learning rate
# (CARRIER_LR). transatt_unet's PAM gamma (zero at init: the spatial
# attention would add nothing) is set to PAM_GAMMA on every model built.
# vnet's channel dropout (0.5) and transatt_unet's attention dropout (0.1)
# draw from a generator re-seeded to DROPOUT_SEED before every step, so that
# the steps descend one objective.
CONV_MEMBERS = ("raunet", "transatt_unet", "unet_transformer", "multiresunet", "vnet")
PAM_GAMMA = 0.5
DROPOUT_SEED = 7
# profile_forward: most traces of one call, and the traces it took beyond two
PROFILE_TRIES = 5
PROFILE_RETAKES = [0]


def log(*a):
    print(*a, flush=True)


def lap(name, since):
    """Logs the seconds one phase of the run took since ``since``; returns
    the time now."""
    now = time.perf_counter()
    log(f"phase {name}: {now - since:.1f} s")
    return now


def stage_case(torch, gen, b, cin, cu, cs, co, hc, wc, device):
    """Random bf16 stage inputs with O(1) outputs, packed as the kernel takes them."""
    cl = torch.channels_last
    n = lambda *s: torch.randn(*s, generator=gen, device=device)
    y = n(b, cin, hc, wc).to(torch.bfloat16).contiguous(memory_format=cl)
    skip = n(b, cs, 2 * hc, 2 * wc).to(torch.bfloat16).contiguous(memory_format=cl)
    wt = (n(cin, 4 * cu) / cin ** 0.5).to(torch.bfloat16)
    wc_ = (n(9 * (cu + cs), co) * (2.0 / (9 * (cu + cs))) ** 0.5).to(torch.bfloat16)
    return (y, skip, wt, n(cu) * 0.1, wc_, 1.0 + 0.2 * n(co), 0.1 * n(co))


def cuda_ms(torch, fn, iters):
    """Mean ms of ``fn()`` over ``iters`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters):
    """Mean device ms of ``fn()`` over ``iters`` calls captured in one CUDA
    graph and replayed (CUDA events around three replays): the launches'
    host cost, which exceeds a small kernel's device time on a loaded host,
    stays out."""
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
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def work(b, cin, cu, cs, co, hc, wc):
    """K1's operations and its least bytes: each input read once, the output
    written once (bf16 tensors and weights, f32 bt/scale/bias)."""
    hf, wf = 2 * hc, 2 * wc
    flops = 2 * (b * hc * wc * cin * 4 * cu + b * hf * wf * 9 * (cu + cs) * co)
    nbytes = (2 * (b * hc * wc * cin + b * hf * wf * cs + b * hf * wf * co
                   + cin * 4 * cu + 9 * (cu + cs) * co) + 4 * (cu + 2 * co))
    return flops, nbytes


def bound(flops, nbytes, f32_ops=0, int8_ops=0):
    """(ms, what bounds it): the least time the card could take for the work.
    ``flops`` run on the bf16 tensor cores, ``int8_ops`` on the int8 tensor
    cores, ``f32_ops`` on the CUDA cores; the units overlap, so the slowest
    of them bounds the operations."""
    t_ops = max(flops / PEAK_BF16_FLOPS, int8_ops / PEAK_INT8_OPS, f32_ops / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mkblock_work(b, c, h, w):
    """K4: (tensor-core FLOPs, f32 FLOPs, least bytes). The MLP's two GEMMs
    are 16*M*C^2 FLOPs; the cascade is 83 depthwise taps per channel chain
    per pixel (2 FLOPs each). Bytes: x read and out written once (bf16), the
    bf16 weights and the f32 taps, affines and biases once."""
    m, q = b * h * w, c // 4
    return (16 * m * c * c, 2 * 83 * q * m,
            2 * 2 * m * c + 2 * 8 * c * c + 4 * (89 * q + 5 * c))


def morph_work(b, c, h, w, k, repeat):
    """K5: (f32 operations, least bytes). Softmax about 5 operations per
    element, each round 2 separable passes of k-1 comparisons for d and for
    e; x read once, d and e written once (bf16)."""
    n = b * c * h * w
    return n * (5 + 4 * (k - 1) * repeat), 3 * 2 * n


def trace_once(torch, fn):
    """Device events of one traced call of ``fn`` (synchronised), without
    the ranges of user annotations (such as ``Optimizer.step``), which span
    kernels already counted. A short spin kernel opens each trace and is left
    out: the profiler often lost the first kernel of a trace (the int8
    float32 unet's first conv, 17 P2 grids seen of 18 launched)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and "spin_kernel" not in e.name]


def profile_forward(torch, fn):
    """Device events of one whole traced call of ``fn``, which must launch
    the same kernels on every call. The profiler now and then loses a block of a
    trace's kernel records (on the H100 a repeated mmunet trace lost some of
    its K4 and K5 grids once), so ``fn`` is traced until two traces in a row
    hold as many device events, and the second is read; after
    PROFILE_TRIES traces, the fullest. PROFILE_RETAKES counts the traces
    taken beyond the first two."""
    traces = [trace_once(torch, fn), trace_once(torch, fn)]
    while len(traces[-1]) != len(traces[-2]) and len(traces) < PROFILE_TRIES:
        log(f"profiler: traces of {len(traces[-2])} and {len(traces[-1])} device events; "
            "tracing again")
        PROFILE_RETAKES[0] += 1
        traces.append(trace_once(torch, fn))
    if len(traces[-1]) == len(traces[-2]):
        return traces[-1]
    return max(traces, key=len)


def serve_times(torch, preds, x):
    """Median ms per forward on each path: 10 samples of 3 forwards, paths in turns."""
    times = {name: [] for name in preds}
    for fn in preds.values():
        for _ in range(3):
            fn(x)
    names = list(preds)
    for r in range(10):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(cuda_ms(torch, lambda: preds[name](x), 3))
    return times


def breakdown(torch, name, fn, forward_ms, counts=None):
    """Log where one call's device time goes (a forward, or a train step), by
    kernel, and the idle share; ``counts``, if given, gets each kernel's
    launches."""
    per = {}
    for e in profile_forward(torch, fn):
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        if counts is not None:
            counts[e.name] = counts.get(e.name, 0) + 1
    busy = sum(per.values())
    log(f"{name} path device time {busy:.4f} ms of {forward_ms:.4f} ms per call "
        f"(idle share {1 - busy / forward_ms:.3f}); top kernels:")
    for kname, ms in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms:8.4f} ms  {kname[:110]}")
    return busy


def random_mkblock(torch, c, dtype, device, seed):
    """An eval MKBlock (no attention tail) with seeded weights and BN off identity."""
    from unet_zoo_tpu_torch.models.mmunet import MKBlock
    from unet_zoo_tpu_torch.nn import init_weights

    blk = MKBlock(c, dtype=dtype, use_kernels=False)
    g = torch.Generator().manual_seed(seed)
    init_weights(blk, g)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
    return blk.to(device).eval()


def bf16_input(torch, gen, shape, device, scale=1.0):
    x = scale * torch.randn(*shape, generator=gen, device=device)
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def k4_reading(torch, got, ref, x):
    """K4's error beyond its output rounding, as a share of the MLP branch:
    max over elements of (|got - ref| - 2^-8 |ref|) / rms(ref - x). The
    kernel rounds its output to bf16, at most half an ulp (2^-8 |ref|) off;
    what remains comes from h0 and hidden elements that the kernel and the
    plain version round to neighbouring bf16 values, where their two f32
    sums (taken in other orders) straddle a rounding midpoint."""
    excess = (got.float() - ref).abs() - 2.0 ** -8 * ref.abs()
    return (excess.max() / (ref - x.float()).pow(2).mean().sqrt()).item()


def k5_reading(got, ref):
    """K5's largest relative error, max |got - ref| / |ref| (softmax > 0)."""
    return ((got.float() - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()


def mkblock_border_fault(torch, x, taps, affine, w1, b1, w2, b2):
    """K4's plain version with the cascade's padding trap planted: the
    intermediates a and b are gelu(t) outside the image instead of zero, so
    the dw5 and dw7 convs see them in their padding. Rounded as the kernel
    rounds its output; the K4 comparison must reject it."""
    F = torch.nn.functional
    q = x.shape[1] // 4
    quarters = x.float().split(q, dim=1)
    aff = affine.view(6, 1, q, 1, 1)
    z, fill, outs, kbase = None, None, [], 0
    for i, k in enumerate((3, 5, 7)):
        wt = taps[kbase:kbase + k * k].t().reshape(q, 1, k, k)
        kbase += k * k
        inp = quarters[i] if z is None else z + quarters[i]
        inp = F.pad(inp, (k // 2,) * 4) if fill is None else F.pad(inp - fill, (k // 2,) * 4) + fill
        z = F.gelu(F.conv2d(inp, wt, groups=q) * aff[2 * i] + aff[2 * i + 1])
        fill = F.gelu(aff[2 * i + 1])
        outs.append(z)
    h0 = torch.cat(outs + [quarters[3]], dim=1).permute(0, 2, 3, 1).to(torch.bfloat16).float()
    hid = F.gelu(h0 @ w1.float() + b1).to(torch.bfloat16).float()
    return (x.float() + (hid @ w2.float() + b2).permute(0, 3, 1, 2)).to(torch.bfloat16)


def morph_faults(torch, x, repeat, d_ref, e_ref):
    """Planted K5 faults, each (name, got, ref): d or e all zero, the wrong
    window (5 for 7), e re-padded with 0 instead of +inf each round; for two
    rounds also the second round alone padded with 0, and with the maps'
    pads swapped (+inf for d, -inf for e). (A second round with no re-pad
    at all equals the reference, tests/test_torch_morph_plan.py.) Where the
    plan has more than one strip or band, the kernel itself launched with a
    strip halo or a band halo one pixel short of R (``morph.short_halo_fault``)."""
    from unet_zoo_tpu_torch.ops.kernels import morph as k5

    F = torch.nn.functional
    d5, e5 = k5.fused_softmax_morph_reference(x.float(), 5, repeat)
    sm = torch.softmax(x.float(), dim=1)
    e0 = sm
    for _ in range(repeat):
        e0 = -F.max_pool2d(F.pad(-e0, (3, 3, 3, 3), value=0.0), 7, 1)
    faults = [("d zero", torch.zeros_like(d_ref), d_ref),
              ("e zero", torch.zeros_like(e_ref), e_ref),
              ("d 5x5", d5, d_ref), ("e 5x5", e5, e_ref),
              ("e 0-padded", e0.to(torch.bfloat16), e_ref)]
    if repeat == 2:
        d1, e1 = F.max_pool2d(sm, 7, 1, 3), -F.max_pool2d(-sm, 7, 1, 3)
        second = lambda t, pad: F.max_pool2d(F.pad(t, (3, 3, 3, 3), value=pad), 7, 1)
        faults += [("e 2nd round 0-padded", (-second(-e1, 0.0)).to(torch.bfloat16), e_ref),
                   ("d 2nd round +inf-padded", second(d1, float("inf")).to(torch.bfloat16), d_ref),
                   ("e 2nd round -inf-padded", (-second(-e1, float("inf"))).to(torch.bfloat16),
                    e_ref)]
    b, c, h, w = x.shape
    p = k5.plan(b, c, h, w, repeat)
    for side, pieces in (("strip", -(-w // p.tw)), ("band", -(-h // p.bh))):
        if pieces > 1:
            d, e = k5.short_halo_fault(x, repeat, side)
            faults += [(f"d {side} halo R-1", d, d_ref), (f"e {side} halo R-1", e, e_ref)]
    return faults


def check_k4_k5(torch, gen, device):
    """K4 and K5 against their plain versions (f32, TF32 off) at every
    distinct full-width shape and one odd shape, each beside planted faults
    that the same comparison must reject; returns the max abs errors."""
    from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
    from unet_zoo_tpu_torch.ops.kernels import morph as k5

    k4_err = 0.0
    cases = [(2 if h >= 128 else SERVE_BATCH, c, h, h) for c, h, _ in MKBLOCK_SHAPES]
    cases += K4_EDGE_CASES
    for b, c, h, w in cases:
        blk = random_mkblock(torch, c, torch.float32, "cpu", c + h)
        weights = [t.to(device) for t in k4.fold_mkblock_params(blk)]
        x = bf16_input(torch, gen, (b, c, h, w), device)
        got = k4.fused_mkblock(x, *weights)
        ref = k4.fused_mkblock_reference(x.float(), *weights)
        fault = mkblock_border_fault(torch, x, *weights)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        reading, fault_reading = k4_reading(torch, got, ref, x), k4_reading(torch, fault, ref, x)
        err = (got.float() - ref).abs().max().item()
        log(f"K4 x={[b, c, h, w]}: max_abs_err {err:.3e}; beyond output rounding "
            f"{reading:.3e} of the branch rms (limit {K4_BRANCH_SHARE:.0e}); planted border "
            f"fault {fault_reading:.3e}")
        if not reading <= K4_BRANCH_SHARE:
            raise AssertionError(f"K4 disagrees with its plain version: {reading}")
        if not fault_reading > K4_BRANCH_SHARE:
            raise AssertionError(f"the K4 comparison passed a planted fault: {fault_reading}")
        k4_err = max(k4_err, err)

    k5_err = 0.0
    cases = [(SERVE_BATCH, c, h, h) for c, h, _, _ in MORPH_SHAPES]
    cases.append((1, 24, 37, 29))
    for b, c, h, w in cases:
        x = bf16_input(torch, gen, (b, c, h, w), device, scale=2.0)
        for repeat in (1, 2):
            d, e = k5.fused_softmax_morph(x, 7, repeat)
            d_ref, e_ref = k5.fused_softmax_morph_reference(x.float(), 7, repeat)
            faults = morph_faults(torch, x, repeat, d_ref, e_ref)
            d2, e2 = k5.fused_softmax_morph(x, 7, repeat)
            torch.cuda.synchronize()
            p = k5.plan(b, c, h, w, repeat)
            geometry = k5.source_geometry(b, c, h, w, repeat, p)
            rel = {"d": k5_reading(d, d_ref), "e": k5_reading(e, e_ref)}
            caught = {name: k5_reading(got, ref) for name, got, ref in faults}
            log(f"K5 x={[b, c, h, w]} repeat={repeat} plan cb={p.cb} tw={p.tw} bh={p.bh} "
                f"grid={p.grid} threads={p.threads} smem={p.smem} stats blocks "
                f"{p.stats_blocks}: max rel err d {rel['d']:.3e}, e {rel['e']:.3e} (limit "
                f"{K5_REL:.4e}); least planted fault {min(caught.values()):.3e} "
                f"({min(caught, key=caught.get)}) of {len(caught)}")
            if not max(rel.values()) <= K5_REL:
                raise AssertionError(f"K5 disagrees with its plain version: {rel}")
            if not min(caught.values()) > K5_REL:
                raise AssertionError(f"the K5 comparison passed a planted fault: {caught}")
            if not (torch.equal(d, d2) and torch.equal(e, e2)):
                raise AssertionError("two K5 launches differ")
            if geometry != (*p.grid, p.threads, p.smem, p.stats_blocks, p.rows):
                raise AssertionError(f"K5 source geometry {geometry} is not the plan's {p}")
            k5_err = max(k5_err, (d.float() - d_ref).abs().max().item(),
                         (e.float() - e_ref).abs().max().item())
    return k4_err, k5_err


def serve_both_paths(torch, gen, device, name, batch, image, counters, rel_l2_max, agree_min,
                     f32_ratio=None, prepare=None, decide=True, **kwargs):
    """``name`` served in bf16 on the kernel path and on the plain module path
    with the same seeded weights. Sets every ``counters`` entry ({wrapper
    module: LAUNCHES key}) to 0 just before one kernel-path forward and reads
    them just after; compares the logits (relative L2 <= ``rel_l2_max``), the
    masks (agreement >= ``agree_min``) and each path's distance to float32
    compute on the same bf16-rounded weights (kernel path at most
    ``f32_ratio`` times the plain path's, when given). ``prepare(module)``,
    if given, changes every model's weights alike before it is served;
    ``kwargs`` go to ``create_model``. With ``decide`` False the bars are
    only logged (the caller decides on many inputs). Returns the two predictors, the input,
    the launches, the agreement figures and the plain path's and the float32
    compute's logits."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.utils.serving import make_predictor

    def build(**kw):
        model = create_model(name, seed=0, image_size=image, **kwargs, **kw)
        if prepare is not None:
            prepare(model.module)
        return model

    x = torch.randn(batch, 3, image, image, generator=gen, device=device)
    kern = build(dtype=torch.bfloat16)
    plain = build(dtype=torch.bfloat16, use_kernels=False)
    log(f"{name}: {sum(p.numel() for p in kern.module.parameters()) / 1e6:.2f} M parameters")
    preds = {"kernel": make_predictor(kern, None, "logits"),
             "plain": make_predictor(plain, None, "logits")}

    for mod, key in counters:
        mod.LAUNCHES[key] = 0
    logits_k = preds["kernel"](x)
    torch.cuda.synchronize()
    launches = {key: mod.LAUNCHES[key] for mod, key in counters}
    logits_p = preds["plain"](x)
    mask_k = make_predictor(kern, None, "mask")(x)
    mask_p = make_predictor(plain, None, "mask")(x)
    torch.cuda.synchronize()
    log(f"main path: {launches} in one {name} forward (B={batch}, {image}px)")
    for t in (logits_k, logits_p):
        assert t.shape == (batch, 1, image, image) and torch.isfinite(t.float()).all()
    lk, lp = logits_k.float(), logits_p.float()
    rel_l2 = ((lk - lp).norm() / lp.norm()).item()
    agree = (mask_k == mask_p).float().mean().item()
    exact = build(use_kernels=False)
    lf = make_predictor(exact, None, "logits")(x).float()
    del exact
    dist = {k: ((t - lf).norm() / lf.norm()).item() for k, t in (("kernel", lk), ("plain", lp))}
    log(f"serve {name}: logits std {lp.std().item():.4f}, rel L2 kernel vs plain {rel_l2:.3e} "
        f"(<= {rel_l2_max:.0e}), mask agreement {agree:.5f} (>= {agree_min}); rel L2 to f32 "
        f"compute: kernel path {dist['kernel']:.3e}, plain path {dist['plain']:.3e}"
        + (f" (kernel <= {f32_ratio} x plain)" if f32_ratio else ""))
    if decide and not (rel_l2 <= rel_l2_max and agree >= agree_min
                       and (f32_ratio is None or dist["kernel"] <= f32_ratio * dist["plain"])):
        raise AssertionError(f"{name} kernel path disagrees with the plain path")
    return (preds, x, launches, dict(rel_l2=rel_l2, mask_agreement=agree, rel_l2_to_f32=dist),
            {"plain": lp, "f32": lf})


def time_paths(torch, name, preds, x, profile):
    """img/s of both paths and, with ``profile``, their device-time breakdowns."""
    batch, image = x.shape[0], x.shape[-1]
    times = serve_times(torch, preds, x)
    med = {k: statistics.median(v) for k, v in times.items()}
    rates = {k: batch / (m / 1e3) for k, m in med.items()}
    for path in ("kernel", "plain"):
        q = statistics.quantiles(times[path], n=4)
        log(f"serve {name} bf16 B={batch} {image}px, {path} path: {rates[path]:.1f} img/s "
            f"(forward median {med[path]:.4f} ms, quartiles {q[0]:.4f}-{q[2]:.4f} ms)")
    busy = None
    if profile:
        busy = {path: breakdown(torch, f"{name} {path}", lambda: fn(x), med[path])
                for path, fn in preds.items()}
    return rates, med, busy


def serve_mmunet(torch, gen, device):
    """Full-width mmunet on both paths: agreement, launches, rates, breakdown."""
    from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
    from unet_zoo_tpu_torch.ops.kernels import morph as k5

    preds, x, launches, agreement, _ = serve_both_paths(
        torch, gen, device, "mmunet", SERVE_BATCH, IMAGE,
        [(k4, "fused_mkblock"), (k5, "fused_softmax_morph")], MMUNET_REL_L2, 0.99)
    want = {"fused_mkblock": sum(n for *_, n in MKBLOCK_SHAPES),
            "fused_softmax_morph": sum(n for *_, n in MORPH_SHAPES)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # every K4 launch is a cascade grid and an MLP: one fused grid (C <= 192),
    # or a hidden-layer GEMM grid and an output GEMM grid (mkblock_gemm<1>)
    # or a split one (mkblock_gemm<2>) and its reduction; every K5 launch is a
    # statistics grid and a pool grid
    events = profile_forward(torch, lambda: preds["kernel"](x))
    count = lambda key: sum(key in e.name for e in events)
    seen = {key: count(key) for key in ("mkblock_cascade", "mkblock_mlp<", "mkblock_gemm<0>",
                                         "mkblock_gemm<1>", "mkblock_gemm<2>", "mkblock_reduce",
                                         "softmax_stats_kernel", "softmax_morph_kernel")}
    log(f"profiler: {seen}")
    mlps = seen["mkblock_mlp<"] + seen["mkblock_gemm<0>"]
    outputs = seen["mkblock_gemm<1>"] + seen["mkblock_reduce"]
    if not (seen["mkblock_cascade"] == mlps == want["fused_mkblock"]
            and outputs == seen["mkblock_gemm<0>"]
            and seen["mkblock_gemm<2>"] == seen["mkblock_reduce"]
            and seen["softmax_stats_kernel"] == want["fused_softmax_morph"]
            and seen["softmax_morph_kernel"] == want["fused_softmax_morph"]):
        raise AssertionError(f"profiler did not see K4 on every MKBlock and K5 on every gate: "
                             f"{seen}, launches {want}")

    rates, med, busy = time_paths(torch, "mmunet", preds, x, profile=True)
    return launches, rates, med, busy, agreement


def time_k4_k5(torch, gen, device):
    """K4 and K5 at each launch shape of the B=8 forward: kernel, plain
    version, bound and the bf16 module chain each replaces."""
    from unet_zoo_tpu_torch.models.mmunet import softmax_morph
    from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
    from unet_zoo_tpu_torch.ops.kernels import morph as k5
    from unet_zoo_tpu_torch.probes.mkblock_grids import grid_split
    from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference

    k4_rows = []
    for c, h, n in MKBLOCK_SHAPES:
        b = SERVE_BATCH
        # the predictor's module path: bf16-rounded parameters, bf16 compute;
        # the kernel path's weights folded and packed once, as frozen
        blk = cast_params_for_inference(random_mkblock(torch, c, torch.bfloat16, device, c + h))
        weights = k4.fold_mkblock_params(blk)
        packed = k4.pack_mkblock_weights(weights.w1, weights.w2)
        x = bf16_input(torch, gen, (b, c, h, h), device)
        kernel = lambda: k4.fused_mkblock(x, *weights, packed=packed)
        with torch.inference_mode():
            ms = cuda_ms(torch, kernel, 20)
            device_graph_ms = graph_ms(torch, kernel, 20)
            plain_ms = cuda_ms(torch, lambda: k4.fused_mkblock_reference(x, *weights), 5)
            chain_ms = cuda_ms(torch, lambda: blk(x), 20)
            # each grid's device time per launch, by kernel name, from the profiler
            grids = {name: ms_ for name, (ms_, _) in grid_split(kernel, 10).items()}
        tc, f32, nbytes = mkblock_work(b, c, h, h)
        bound_ms, bound_by = bound(tc, nbytes, f32)
        k4_rows.append(dict(x=[b, c, h, h], launches=n, tc_flops=tc, f32_flops=f32,
                            bytes=nbytes, ms=ms, plain_ms=plain_ms, module_chain_ms=chain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, graph_ms=device_graph_ms,
                            grids_ms=grids, device_ms=sum(grids.values()),
                            tflops=tc / ms / 1e9))
        log(f"K4 x={[b, c, h, h]} x{n}: {ms:.4f} ms ({tc / ms / 1e9:.1f} TFLOP/s), by graph "
            f"{device_graph_ms:.4f} ms, device {sum(grids.values()):.4f} ms ("
            + ", ".join(f"{name} {g:.4f}" for name, g in grids.items())
            + f"), plain {plain_ms:.4f} ms, module chain {chain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")

    k5_rows = []
    for c, h, repeat, n in MORPH_SHAPES:
        b = SERVE_BATCH
        x = bf16_input(torch, gen, (b, c, h, h), device, scale=2.0)
        kernel = lambda: k5.fused_softmax_morph(x, 7, repeat)
        with torch.inference_mode():
            ms = cuda_ms(torch, kernel, 20)
            device_graph_ms = graph_ms(torch, kernel, 20)
            plain_ms = cuda_ms(torch, lambda: k5.fused_softmax_morph_reference(x, 7, repeat), 5)
            chain_ms = cuda_ms(torch, lambda: softmax_morph(x, repeat, False, False), 20)
            grids = {name: ms_ for name, (ms_, _) in grid_split(kernel, 10).items()}
        ops, nbytes = morph_work(b, c, h, h, 7, repeat)
        bound_ms, bound_by = bound(0, nbytes, ops)
        k5_rows.append(dict(x=[b, c, h, h], repeat=repeat, launches=n, f32_ops=ops,
                            bytes=nbytes, ms=ms, plain_ms=plain_ms, module_chain_ms=chain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, graph_ms=device_graph_ms,
                            grids_ms=grids, device_ms=sum(grids.values()),
                            gbytes_per_s=nbytes / device_graph_ms / 1e6))
        log(f"K5 x={[b, c, h, h]} repeat={repeat} x{n}: {ms:.4f} ms, by graph "
            f"{device_graph_ms:.4f} ms ({nbytes / device_graph_ms / 1e6:.1f} GB/s), device "
            f"{sum(grids.values()):.4f} ms ("
            + ", ".join(f"{name} {g:.4f}" for name, g in grids.items())
            + f"), plain {plain_ms:.4f} ms, module chain {chain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    return k4_rows, k5_rows


def axial_work(n, length, g, gp, ks, wopos):
    """K6: (f32 operations, least bytes). Per (row, group, i, j): 6c + 4gp + 5
    operations with c = gp/2 (2c + 2gp + 5 for wopos): the three similarity
    dot products, sv and sve, max, exp, sum. Bytes: qkv read and the output
    written once (bf16), the scale tables and ``relative`` once (f32)."""
    c = gp // 2
    per = 2 * c + 2 * gp + 5 if wopos else 6 * c + 4 * gp + 5
    tables = 3 * g + 3 * g * gp + (0 if wopos else 2 * gp * (2 * ks - 1))
    return n * g * length * length * per, 2 * 3 * n * length * g * gp + 4 * tables


def k6_case(torch, gen, b, h, w, gp, ks, wopos, device):
    """Random K6 operands (bf16 qkv, f32 tables) with O(1) scales, so that
    every term of the similarity and of the output shows."""
    g = AXIAL_GROUPS
    u = lambda *s: 0.5 + torch.rand(*s, generator=gen, device=device)
    qkv = bf16_input(torch, gen, (b, 2 * g * gp, h, w), device)
    relative = None if wopos else (torch.randn(2 * gp, 2 * ks - 1, generator=gen, device=device)
                                   / gp ** 0.5)
    sim_scale, out_scale = u(3, g), u(2, g, gp)
    if wopos:
        sim_scale[1:] = 0.0
        out_scale[1] = 0.0
    shift = 0.1 * torch.randn(g, gp, generator=gen, device=device)
    return qkv, relative, sim_scale, out_scale, shift


def k6_reading(got, ref):
    """K6's error beyond its output rounding, as a share of the output:
    max over elements of (|got - ref| - 2^-8 |ref|) / rms(ref)."""
    excess = (got.float() - ref).abs() - 2.0 ** -8 * ref.abs()
    return (excess.max() / ref.pow(2).mean().sqrt()).item()


def k6_faults(torch, qkv, relative, sim_scale, out_scale, shift, ks, width_axis):
    """K6's plain version (f32) with one fault planted each: the softmax
    taken over the queries i (``torch.softmax`` redirected for that one
    call) and, in the positional modes, through the plain version's own
    arguments: k's embedding read untransposed (the k rows of ``relative``
    reversed, which transposes k_emb alone) and the sve term dropped."""
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

    def plain(rel, scale):
        return k6.fused_axial_attention_reference(qkv, rel, sim_scale, scale, shift, ks,
                                                  width_axis)

    softmax = torch.softmax
    torch.softmax = lambda t, dim: softmax(t, dim=-2)
    try:
        faults = [("softmax over i", plain(relative, out_scale))]
    finally:
        torch.softmax = softmax
    if relative is not None:
        faults += [(name, plain(*args)) for name, args in k6_arg_faults(
            torch, relative, out_scale)]
    return faults


def k6_arg_faults(torch, relative, out_scale):
    """Faults that K6's arguments can carry, each (name, (relative,
    out_scale)): the k embedding untransposed, the sve term dropped."""
    gp = out_scale.shape[2]
    k_flat = relative.clone()
    k_flat[gp // 2:gp] = relative[gp // 2:gp].flip(-1)
    no_sve = out_scale.clone()
    no_sve[1] = 0.0
    return [("k_emb untransposed", (k_flat, out_scale)), ("sve dropped", (relative, no_sve))]


def k6_design_faults(length, gp, wopos):
    """The design faults that can show at a K6 shape: the rescale where
    every key split walks 8 key tiles or more, the partial tile where L is
    not a multiple of R, the merge where the keys are split."""
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

    if wopos:
        return []
    p = k6.plan(1, 1, length, gp, wopos)
    apply = {"rescale skipped": p.tiles // p.splits >= 8,
             "partial key tile dropped": length % p.rows_per_lane != 0,
             "key-split merge dropped": p.splits > 1}
    return [name for name, ok in apply.items() if ok]


def check_k6(torch, gen, device):
    """K6 against its plain version (f32) at every launch shape on both axes,
    in wopos mode at two shapes, at an odd shape with L < ks, at L = 33, 127
    and 129 and at every gp at L = 128, each beside planted faults that the
    same comparison must reject (the design faults on sharpened operands,
    where they apply) and launched twice bit for bit; returns the max abs
    error."""
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

    cases = [(SERVE_BATCH, s, s, gp, ks, False, axis) for s, gp, ks, _ in AXIAL_SHAPES
             for axis in (False, True)]
    cases += [(SERVE_BATCH, 128, 128, 4, 128, True, False),
              (SERVE_BATCH, 32, 32, 16, 32, True, True)]
    cases.append((1, 29, 37, 4, 40, False, False))   # N = 37 rows, L = 29 < ks = 40
    cases += [(2, 33, 5, 4, 33, False, False), (1, 7, 127, 2, 127, False, True),
              (1, 129, 3, 8, 129, False, False)]
    cases += [(1, 3, 128, gp, 128, False, True) for gp in (2, 4, 8, 16, 32)]
    err = 0.0
    for b, h, w, gp, ks, wopos, width_axis in cases:
        args = k6_case(torch, gen, b, h, w, gp, ks, wopos, device)
        got = k6.fused_axial_attention(*args, ks, width_axis)
        again = k6.fused_axial_attention(*args, ks, width_axis)
        f32 = [None if a is None else a.float() for a in args]
        ref = k6.fused_axial_attention_reference(*f32, ks, width_axis)
        caught = {name: k6_reading(out, ref) for name, out in
                  k6_faults(torch, *f32, ks, width_axis)}
        length = w if width_axis else h
        design = k6_design_faults(length, gp, wopos)
        if design:
            sharp = list(args)
            sharp[2] = K6_SHARPEN * args[2]
            sharp_ref = k6.fused_axial_attention_reference(
                *[a.float() for a in sharp], ks, width_axis)
            sharp_reading = k6_reading(k6.fused_axial_attention(*sharp, ks, width_axis),
                                       sharp_ref)
            for name in design:
                caught[name] = k6_reading(k6.planted_fault(*sharp, ks, width_axis, name),
                                          sharp_ref)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        if not torch.equal(got, again):
            raise AssertionError(f"K6 gave two results on the same operands at {h}x{w}, gp={gp}")
        reading = k6_reading(got, ref)
        axis = "W" if width_axis else "H"
        n = b * h if width_axis else b * w
        e = (got.float() - ref).abs().max().item()
        # a fault that reads NaN (an empty key split) is rejected as well
        least = min(caught, key=lambda k: caught[k] if caught[k] == caught[k] else float("inf"))
        log(f"K6 qkv={[b, 2 * AXIAL_GROUPS * gp, h, w]} along {axis} (N={n}, L={length}, "
            f"gp={gp}, ks={ks}{', wopos' if wopos else ''}): max_abs_err {e:.3e}; beyond "
            f"output rounding {reading:.3e} of the output rms (limit {K6_SHARE:.0e}); "
            + (f"sharpened x{K6_SHARPEN:g} {sharp_reading:.3e}; " if design else "")
            + f"two launches bit for bit; least planted fault {caught[least]:.3e} ({least}; "
            f"{len(caught)} planted)")
        if not reading <= K6_SHARE or (design and not sharp_reading <= K6_SHARE):
            raise AssertionError(f"K6 disagrees with its plain version: {reading}")
        passed = [name for name, r in caught.items() if r <= K6_SHARE]
        if passed:
            raise AssertionError(f"the K6 comparison passed planted faults {passed}: {caught}")
        err = max(err, e)
    return err


def failed_checks(r, rel_l2_max):
    """The served MedT checks that one forward's readings ``r`` fail: rel L2
    to the plain path, mask agreement, distance to f32 compute over the
    plain path's, and the largest reading of its K6 launches against K6's
    plain version. Plain Python (tested on the CPU)."""
    return [k for k, bad in (("rel_l2", r["rel_l2"] > rel_l2_max),
                             ("mask_agreement", r["mask_agreement"] < MEDT_AGREE),
                             ("f32_ratio", r["f32_ratio"] > MEDT_F32_RATIO),
                             ("launch_reading", r["launch_reading_max"] > K6_SHARE)) if bad]


def none_row_failed(r, rel_l2_max, on_medians):
    """The checks that fail medt_faults' "none" row (no planted fault).
    Without ``on_medians`` (``gated``) the forward's own readings decide, as
    for a fault row. With it (the 128px names) rel L2, mask agreement and
    distance to f32 are decided on the medians over MEDT_INPUTS seeded
    inputs, by medt_bars (medians_failed) before medt_faults runs, with the
    same limits; this row adds every K6 launch of the forward against its
    plain version. Random-weight MedT logits amplify K6's last-bit
    differences 200-fold, so one input swings across the mask bar while
    every launch agrees (PERF.md). Plain Python (tested on the CPU)."""
    if not on_medians:
        return failed_checks(r, rel_l2_max)
    return ["launch_reading"] if not r["launch_reading_max"] <= K6_SHARE else []


def medians_failed(med, rel_l2_max):
    """The bars that medt_bars' medians over MEDT_INPUTS inputs miss: rel L2
    to the plain path, mask agreement, distance to f32 over the plain path's,
    and mask agreement with f32 compute against the plain path's (keys rel,
    kp, ratio, kf and pf). Plain Python (tested on the CPU)."""
    return [k for k, ok in (("rel_l2", med["rel"] <= rel_l2_max),
                            ("mask_agreement", med["kp"] >= MEDT_AGREE),
                            ("f32_ratio", med["ratio"] <= MEDT_F32_RATIO),
                            ("f32_agreement", med["kf"] >= med["pf"] - MEDT_F32_AGREE_SLACK))
            if not ok]


def medt_faults(torch, name, preds, x, refs, plain_to_f32, rel_l2_max, on_medians=False):
    """K6 inside the served bf16 model: every launch of a forward is held
    against K6's plain version on the same operands, the model's own
    activations (k6_reading, limit K6_SHARE). Then faults planted into K6's
    arguments, each through the real kernel on every axis pass that has the
    term: each group's q and k read swapped (every mode) and, in the
    positional modes, the k embedding untransposed and the sve term
    dropped. Each forward is read by every check of the served model
    (against the plain path, its distance to f32 compute, every launch
    against the plain version); every fault must fail at least one. The
    "none" row is decided by none_row_failed (``on_medians``: the 128px
    names, whose medians over MEDT_INPUTS inputs medt_bars has held).
    Returns the readings."""
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

    kernel = k6.fused_axial_attention
    dist = lambda a, b: ((a - b).norm() / b.norm()).item()
    mask = lambda t: torch.sigmoid(t) > 0.5

    def swapped(qkv, relative, sim_scale, out_scale, shift):
        g, gp = out_scale.shape[1], out_scale.shape[2]
        order = torch.cat([torch.arange(gp // 2, gp), torch.arange(gp // 2),
                           torch.arange(gp, 2 * gp)])
        idx = (order + 2 * gp * torch.arange(g)[:, None]).flatten().to(qkv.device)
        qkv = qkv[:, idx].contiguous(memory_format=torch.channels_last)
        return qkv, relative, sim_scale, out_scale, shift

    def arg_fault(which):
        def plant(qkv, relative, sim_scale, out_scale, shift):
            if relative is not None:          # a wopos pass has neither term
                relative, out_scale = dict(k6_arg_faults(torch, relative, out_scale))[which]
            return qkv, relative, sim_scale, out_scale, shift
        return plant

    def checked(plant, passes):
        def launch(*a):
            got = kernel(*(a[:5] if plant is None else plant(*a[:5])), *a[5:])
            f32 = [None if t is None else t.float() for t in a[:5]]
            passes.append(k6_reading(got, k6.fused_axial_attention_reference(*f32, *a[5:])))
            return got
        return launch

    faults = {"none": None, "q and k swapped": swapped}
    if name != "medt":
        faults.update({w: arg_fault(w) for w in ("k_emb untransposed", "sve dropped")})
    readings = {}
    try:
        for fault, plant in faults.items():
            passes = []
            k6.fused_axial_attention = checked(plant, passes)
            lk = preds["kernel"](x).float()
            k6.fused_axial_attention = kernel
            r = dict(rel_l2=dist(lk, refs["plain"]),
                     mask_agreement=(mask(lk) == mask(refs["plain"])).float().mean().item(),
                     f32_ratio=dist(lk, refs["f32"]) / plain_to_f32,
                     launch_reading_max=max(passes))
            failed = (none_row_failed(r, rel_l2_max, on_medians) if plant is None
                      else failed_checks(r, rel_l2_max))
            readings[fault] = dict(r, failed=failed)
            log(f"{name} planted fault {fault}: rel L2 vs plain {r['rel_l2']:.3e} (<= "
                f"{rel_l2_max:.0e}), mask agreement {r['mask_agreement']:.5f} (>= {MEDT_AGREE}), "
                f"distance to f32 {r['f32_ratio']:.3f} x plain's (<= {MEDT_F32_RATIO}), its "
                f"{len(passes)} K6 launches against the plain version at most "
                f"{r['launch_reading_max']:.3e} (<= {K6_SHARE:.0e}): fails {failed or 'nothing'}"
                + (" (decided on its K6 launches; the other bars on the medians over inputs)"
                   if plant is None and on_medians else ""))
    finally:
        k6.fused_axial_attention = kernel
    if readings["none"]["failed"]:
        raise AssertionError(f"{name}: K6 disagrees with its plain version in the served model")
    passed = [f for f, r in readings.items() if f != "none" and not r["failed"]]
    if passed:
        raise AssertionError(f"{name}: the served-model checks passed planted faults {passed}")
    return readings


def serve_medt(torch, gen, device, name, batch, image, profile):
    """One MedT model on both paths: one K6 launch per AxialAttention,
    agreement, planted faults, rates and, with ``profile``, the profiler's
    count of K6 grids and the device-time breakdown."""
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

    rel_l2_max = MEDT_REL_L2["gated" if name == "gated" else "small"]
    preds, x, launches, agreement, refs = serve_both_paths(
        torch, gen, device, name, batch, image, [(k6, "fused_axial_attention")],
        rel_l2_max, MEDT_AGREE, MEDT_F32_RATIO, decide=name == "gated")
    if name != "gated":
        agreement["over_inputs"] = medt_bars(torch, device, name, batch, image, rel_l2_max)
    launches = launches["fused_axial_attention"]
    want = MEDT_LAUNCHES[name]
    if launches != want:
        raise AssertionError(f"K6 ran {launches} times in {name}, expected {want}")
    faults = medt_faults(torch, name, preds, x, refs,
                         agreement["rel_l2_to_f32"]["plain"], rel_l2_max, name != "gated")
    seen = None
    if profile:
        events = profile_forward(torch, lambda: preds["kernel"](x))
        seen = {grid: sum(grid in e.name for e in events) for grid in K6_GRIDS}
        log(f"profiler: K6 grids in one {name} forward {seen} (launches {launches})")
        if any(count != want for count in seen.values()):
            raise AssertionError(f"profiler saw K6 grids {seen} in {name}, expected {want} each")
    rates, med, busy = time_paths(torch, name, preds, x, profile)
    return dict(launches=launches, profiler_grids=seen, serve_img_per_s=rates, forward_ms=med,
                device_busy_ms=busy, planted_faults=faults, **agreement)


def medt_bars(torch, device, name, batch, image, rel_l2_max):
    """The served-model bars of a small MedT model over MEDT_INPUTS seeded
    inputs (``probes/medt_paths.py``'s readings): the medians of the kernel
    path's relative L2 to the plain path (<= ``rel_l2_max``), of the two
    paths' mask agreement (>= MEDT_AGREE) and of the kernel path's distance
    to float32 compute over the plain path's (<= MEDT_F32_RATIO); and the
    kernel path's mask agreement with float32 compute no lower than the plain
    path's by more than MEDT_F32_AGREE_SLACK (medians). Random-weight MedT
    logits amplify rounding, so one input's readings swing across the bars
    while both paths stay as close to float32 compute (PERF.md)."""
    from unet_zoo_tpu_torch.probes.medt_paths import readings

    rows = readings(name, MEDT_INPUTS, batch, image, device)
    med = {k: statistics.median(r[k] for r in rows) for k in ("rel", "kp", "kf", "pf", "ratio")}
    log(f"serve {name} over {MEDT_INPUTS} inputs (medians): rel L2 kernel vs plain "
        f"{med['rel']:.3e} (<= {rel_l2_max:.0e}), mask agreement {med['kp']:.5f} (>= "
        f"{MEDT_AGREE}; {sum(r['kp'] < MEDT_AGREE for r in rows)} inputs under), distance to f32 "
        f"kernel/plain {med['ratio']:.3f} (<= {MEDT_F32_RATIO}; "
        f"{sum(r['ratio'] > MEDT_F32_RATIO for r in rows)} inputs over), masks against f32 "
        f"compute kernel {med['kf']:.5f}, plain {med['pf']:.5f} (kernel >= plain - "
        f"{MEDT_F32_AGREE_SLACK})")
    failed = medians_failed(med, rel_l2_max)
    if failed:
        raise AssertionError(f"{name} kernel path disagrees with the plain path over "
                             f"{MEDT_INPUTS} inputs ({failed}): {med}")
    return med


def random_attention(torch, width, ks, width_axis, mode, device, seed):
    """A bf16 eval AxialAttention with seeded weights, BN off identity and
    bf16-rounded parameters (the predictor's module path)."""
    from unet_zoo_tpu_torch.models.medt_net import AxialAttention
    from unet_zoo_tpu_torch.nn import init_weights
    from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference

    attn = AxialAttention(width, width, AXIAL_GROUPS, ks, width_axis=width_axis, mode=mode,
                          dtype=torch.bfloat16, use_kernels=False)
    g = torch.Generator().manual_seed(seed)
    init_weights(attn, g)
    with torch.no_grad():
        for m in attn.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
    return cast_params_for_inference(attn).to(device).eval()


def time_k6(torch, gen, device):
    """K6 at each launch shape of the B=8 gated forward, both axes: kernel
    (CUDA events and a CUDA graph of 20 launches), plain version, bound, and
    the bf16 module chain it replaces (the module path from bn_qkv to
    bn_output, on the same projections)."""
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

    rows = []
    for s, gp, ks, blocks in AXIAL_SHAPES:
        for width_axis in (False, True):
            b, g = SERVE_BATCH, AXIAL_GROUPS
            attn = random_attention(torch, g * gp, ks, width_axis, "gated", device, s + gp)
            w = k6.fold_axial_params(attn)
            qkv = bf16_input(torch, gen, (b, 2 * g * gp, s, s), device)
            tokens = k6.axis_rows(qkv, width_axis).contiguous()
            tables = (w.relative, w.sim_scale, w.out_scale, w.out_shift)
            with torch.inference_mode():
                kernel = lambda: k6.fused_axial_attention(qkv, *tables, ks, width_axis)
                ms = cuda_ms(torch, kernel, 20)
                graph = graph_ms(torch, kernel, 20)
                plain_ms = cuda_ms(torch, lambda: k6.fused_axial_attention_reference(
                    qkv, *tables, ks, width_axis), 3)
                chain_ms = cuda_ms(torch, lambda: attn.core(tokens), 10)
            ops, nbytes = axial_work(b * s, s, g, gp, ks, False)
            bound_ms, bound_by = bound(0, nbytes, ops)
            axis = "W" if width_axis else "H"
            rows.append(dict(qkv=[b, 2 * g * gp, s, s], axis=axis, n=b * s, length=s, gp=gp,
                             kernel_size=ks, launches=blocks, f32_ops=ops, bytes=nbytes, ms=ms,
                             graph_ms=graph, plain_ms=plain_ms, module_chain_ms=chain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, tflops=ops / graph / 1e9))
            log(f"K6 qkv={[b, 2 * g * gp, s, s]} along {axis} x{blocks}: {ms:.4f} ms by events, "
                f"{graph:.4f} ms by graph ({ops / graph / 1e9:.2f} TFLOP/s f32), plain "
                f"{plain_ms:.4f} ms, module chain {chain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
    # wopos (medt's mode) at the largest shape: kernel against its module chain
    s, gp, ks, _ = AXIAL_SHAPES[1]
    attn = random_attention(torch, AXIAL_GROUPS * gp, ks, False, "wopos", device, 7)
    w = k6.fold_axial_params(attn)
    qkv = bf16_input(torch, gen, (SERVE_BATCH, 2 * AXIAL_GROUPS * gp, s, s), device)
    tokens = k6.axis_rows(qkv, False).contiguous()
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: k6.fused_axial_attention(
            qkv, None, w.sim_scale, w.out_scale, w.out_shift, ks, False), 20)
        chain_ms = cuda_ms(torch, lambda: attn.core(tokens), 10)
    log(f"K6 wopos qkv={[SERVE_BATCH, 2 * AXIAL_GROUPS * gp, s, s]} along H: {ms:.4f} ms, "
        f"module chain {chain_ms:.4f} ms")
    return rows, dict(qkv=[SERVE_BATCH, 2 * AXIAL_GROUPS * gp, s, s], ms=ms,
                      module_chain_ms=chain_ms)


def k7_operands(torch, gen, b, h, w, gp, ks, width_axis, device):
    """K7's operands as AxialAttention hands them over at one launch shape:
    the rows of a bf16 [B, 2 g gp, H, W] projection along the axis, with q,
    k and v strided slices of it (q and k offset by 0.5 so that the terms'
    means, and var's -mu^2, are not zero); qg = 0.3 q, kg = 0.7 k; float32
    ``relative`` and gamma; bf16 upstream gradients of sv and sve."""
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

    g, c = AXIAL_GROUPS, gp // 2
    offset = ((torch.arange(2 * gp, device=device) < gp).float() * 0.5).repeat(g)
    x = torch.randn(b, 2 * g * gp, h, w, generator=gen, device=device) + offset.view(1, -1, 1, 1)
    qkv = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    rows = k6.axis_rows(qkv, width_axis)
    n, length = rows.shape[:2]
    rows = rows.reshape(n, length, g, 2 * gp)
    q, k, v = rows[..., :c], rows[..., c:gp], rows[..., gp:]
    r = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    ops = [q, k, (q.float() * 0.3).to(torch.bfloat16), (k.float() * 0.7).to(torch.bfloat16), v,
           r(2 * gp, 2 * ks - 1) / gp ** 0.5, 1.0 + 0.2 * r(3, g)]
    cts = [r(n, length, g, gp).to(torch.bfloat16) for _ in range(2)]
    return ops, cts


def k7_outputs(outs, grads, gp):
    """K7's thirteen outputs by name: the four results and the gradients of
    q, k, qg, kg, v, the q, k and v rows of ``relative``, and gamma."""
    return dict(zip(K7_OUTPUTS, (*outs, *grads[:5], grads[5][:gp // 2], grads[5][gp // 2:gp],
                                 grads[5][gp:], grads[6])))


def k7_run(torch, fn, ops, cts, ks):
    """``fn`` (K7 or its plain version) forward and backward on ``ops``
    (also inside another backward, where grad mode is off)."""
    leaves = [t.detach().requires_grad_() for t in ops]
    with torch.enable_grad():
        outs = fn(*leaves, ks)
        grads = torch.autograd.grad(outs[:2], leaves, [c.to(outs[0].dtype) for c in cts])
    return k7_outputs(outs, grads, ops[4].shape[-1])


def k7_reference(torch, ops, cts, ks):
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7

    return k7_run(torch, k7.fused_axial_train_reference, [t.float() for t in ops],
                  [c.float() for c in cts], ks)


def k7_readings(got, ref):
    """Each output's error beyond its own rounding (half a bf16 ulp for the
    bf16 outputs, none for the float32 ones), as a share of its rms."""
    out = {}
    for name in K7_OUTPUTS:
        g, r = got[name].float(), ref[name].float()
        rounding = 2.0 ** -8 * r.abs() if got[name].element_size() == 2 else 0.0   # bf16
        out[name] = (((g - r).abs() - rounding).max() / r.pow(2).mean().sqrt()).item()
    return out


def k7_faults(torch, ops, cts, ks, ref):
    """K7 through its real kernels with one fault planted each, by wrapping
    the wrapper's function for one grid: the combine without the e x̂ term
    (e zeroed after fin), var without -mu^2 (a, rsqrt(var + eps) and
    -mu rsqrt(var + eps) re-formed from E[x^2] after stats), d_relative
    (d_v_emb among it) from one bwd block per group (the other blocks'
    partials zeroed after bwd); and kr reading the k embedding untransposed
    (the k rows of ``relative`` reversed). Returns the largest reading of each."""
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7

    def no_e(call):
        call.view("e").zero_()

    def var_without_mu2(call):
        mu, var, gamma = (call.tensors[x] for x in ("mu", "var", "gamma"))
        var.add_(mu * mu)
        inv = torch.rsqrt(var + call.eps)
        call.view("consts").copy_(torch.cat([gamma * inv, inv, -mu * inv]).reshape(-1))

    def one_block(call):
        part = call.view("drel_part").view(call.dims["groups"], call.plan.bwd_blocks, -1)
        part[:, 1:].zero_()

    def run(grid=None, after=None, operands=ops):
        saved = getattr(k7, grid) if grid else None
        if grid:
            setattr(k7, grid, lambda call: (saved(call), after(call)))
        try:
            return max(k7_readings(k7_run(torch, k7.fused_axial_train, operands, cts, ks),
                                   ref).values())
        finally:
            if grid:
                setattr(k7, grid, saved)

    gp = ops[4].shape[-1]
    k_flat = ops[5].clone()
    k_flat[gp // 2:gp] = ops[5][gp // 2:gp].flip(-1)
    return {"combine without e x_hat": run("_finish", no_e),
            "var without -mu^2": run("_stats", var_without_mu2),
            "d_relative from one block": run("_backward_pass", one_block),
            "kr untransposed": run(operands=ops[:5] + [k_flat, ops[6]])}


def check_k7(torch, gen, device):
    """K7 against its plain version, forward and backward, at every launch
    shape of the B=8 gated train step on both axes, at gp 32 with L = 128 and at an odd
    shape (N = 37, L = 29 < ks = 40), each beside planted faults that the
    same readings must reject. Returns the max abs error of sv and sve and
    the largest reading of each output."""
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7

    cases = [(SERVE_BATCH, s, s, gp, ks, axis) for s, gp, ks, _ in AXIAL_SHAPES
             for axis in (False, True)]
    # gp 32 at L = 128: the most sums over queries per lane (d_v: 4 x 32 floats)
    cases += [(2, 128, 128, 32, 128, True), (1, 29, 37, 4, 40, False)]
    err, worst = 0.0, dict.fromkeys(K7_OUTPUTS, 0.0)
    for b, h, w, gp, ks, width_axis in cases:
        ops, cts = k7_operands(torch, gen, b, h, w, gp, ks, width_axis, device)
        ref = k7_reference(torch, ops, cts, ks)
        got = k7_run(torch, k7.fused_axial_train, ops, cts, ks)
        caught = k7_faults(torch, ops, cts, ks, ref)
        torch.cuda.synchronize()
        readings = k7_readings(got, ref)
        n, length = ops[0].shape[:2]
        e = max((got[k].float() - ref[k]).abs().max().item() for k in ("sv", "sve"))
        top = max(readings, key=readings.get)
        log(f"K7 N={n} L={length} gp={gp} ks={ks} along {'W' if width_axis else 'H'}: sv/sve "
            f"max_abs_err {e:.3e}; largest reading {readings[top]:.3e} ({top}; limit "
            f"{K7_SHARE:.0e}); " + ", ".join(f"{k} {v:.2e}" for k, v in readings.items()))
        log(f"  planted faults: " + ", ".join(f"{k} {v:.3e}" for k, v in caught.items()))
        if not readings[top] <= K7_SHARE:
            raise AssertionError(f"K7 disagrees with its plain version: {readings}")
        if not min(caught.values()) > K7_SHARE:
            raise AssertionError(f"the K7 comparison passed a planted fault: {caught}")
        err = max(err, e)
        worst = {k: max(worst[k], readings[k]) for k in worst}
        del ref, got
        torch.cuda.empty_cache()
    return err, worst


def checked_k7(torch, readings):
    """K7's wrapper with every launch held against the plain version: the
    forward runs the kernels; the backward runs K7's backward and, on the
    same operands and incoming gradients, the plain version's forward and
    backward, and appends the readings."""
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7

    kernel = k7.fused_axial_train

    class Checked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, qg, kg, v, relative, gamma, ks, eps):
            leaves = [t.detach().requires_grad_() for t in (q, k, qg, kg, v, relative, gamma)]
            with torch.enable_grad():
                outs = kernel(*leaves, ks, eps)
            ctx.leaves, ctx.outs, ctx.ks = leaves, outs, ks
            rets = tuple(o.detach() for o in outs)
            ctx.mark_non_differentiable(rets[2], rets[3])
            return rets

        @staticmethod
        def backward(ctx, d_sv, d_sve, _d_mu, _d_var):
            cts = [d_sv.contiguous(), d_sve.contiguous()]
            grads = torch.autograd.grad(ctx.outs[:2], ctx.leaves, cts)
            gp = ctx.leaves[4].shape[-1]
            got = k7_outputs([o.detach() for o in ctx.outs], grads, gp)
            ref = k7_reference(torch, [t.detach() for t in ctx.leaves], cts, ctx.ks)
            readings.append(k7_readings(got, ref))
            return (*grads, None, None)

    return lambda *a: Checked.apply(*a)


def train_batch(torch, gen, b, size, device):
    """A fixed seeded batch: uint8 images and one uint8 disk mask each."""
    images = torch.randint(0, 256, (b, 3, size, size), generator=gen, device=device,
                           dtype=torch.uint8)
    yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device),
                            indexing="ij")
    centre = size * (0.25 + 0.5 * torch.rand(b, 2, 1, 1, generator=gen, device=device))
    disk = (yy - centre[:, 0]) ** 2 + (xx - centre[:, 1]) ** 2 < (size / 5) ** 2
    return images, disk[:, None].to(torch.uint8)


def rel_l2(torch, a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def train_paths(torch, gen, device, name, batch, image, steps, profile):
    """``name`` trained in bf16 (float32 parameters) through
    ``make_train_step`` on the kernel path and on the module path, from the
    same seeded weights and one fixed batch. Step 1 of each path: K7's
    launches by counter (set to 0 just before the kernel path's step), peak
    memory, and the two paths' gradients and running statistics compared
    (reported). Then ``steps`` - 1 steps of each, in turns, timed; the loss
    must fall on both paths when ``steps`` >= 10. With ``profile``, one
    traced step of each path (K7's grids by name, device busy time, idle
    share) and one step from the seeded weights, on a fresh copy of the
    model, whose every K7 launch is held against the plain version, and whose
    every axis pass is held against float32 (check_train_blocks)."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
    from unet_zoo_tpu_torch.train import create_train_state, make_train_step

    images, masks = train_batch(torch, gen, batch, image, device)
    models = {"kernel": create_model(name, dtype=torch.bfloat16, seed=0, image_size=image),
              "plain": create_model(name, dtype=torch.bfloat16, seed=0, image_size=image,
                                    use_kernels=False)}
    states = {p: create_train_state(m) for p, m in models.items()}
    step = {p: make_train_step(m) for p, m in models.items()}
    losses, peak = {"kernel": [], "plain": []}, {}
    for path in ("kernel", "plain"):
        for key in K7_GRIDS:
            k7.LAUNCHES[key] = 0
        k6.LAUNCHES["fused_axial_attention"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses[path].append(step[path](states[path], images, masks)["loss"])
        torch.cuda.synchronize()
        peak[path] = torch.cuda.max_memory_allocated() / 2 ** 30
        if path == "kernel":
            launches = {key: k7.LAUNCHES[key] for key in K7_GRIDS}
            eval_launches = k6.LAUNCHES["fused_axial_attention"]
    passes = MEDT_LAUNCHES[name]
    log(f"main path: {launches} in one {name} train step (B={batch}, {image}px), K6 "
        f"{eval_launches}; peak memory kernel path {peak['kernel']:.2f} GiB, module path "
        f"{peak['plain']:.2f} GiB")
    if launches != dict.fromkeys(K7_GRIDS, passes) or eval_launches:
        raise AssertionError(f"K7 grids {launches} (K6 {eval_launches}), expected {passes} each")

    # step 1 clipped each path's gradient in place by its own global norm, so
    # gradients are compared as directions (see direction_readings)
    grads = {p: {n: t.grad.float() for n, t in m.module.named_parameters() if t.dim() > 0}
             for p, m in models.items()}
    stats = {p: flat_buffers(torch, m.module) for p, m in models.items()}
    agreement = dict(grad_directions=direction_readings(torch, grads["kernel"], grads["plain"]),
                     running_stats_rel_l2=rel_l2(torch, stats["kernel"], stats["plain"]))
    log(f"{name} step 1, kernel vs module path: loss {losses['kernel'][0].item():.6f} / "
        f"{losses['plain'][0].item():.6f}; gradient directions "
        f"{show_directions(agreement['grad_directions'])}; running statistics rel L2 "
        f"{agreement['running_stats_rel_l2']:.3e}")
    for t in (*grads["kernel"].values(), stats["kernel"]):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite gradients or statistics on the kernel path")

    times = {"kernel": [], "plain": []}
    for r in range(1, steps):
        for path in (("kernel", "plain") if r % 2 else ("plain", "kernel")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[path].append(step[path](states[path], images, masks)["loss"])
            torch.cuda.synchronize()
            times[path].append(1e3 * (time.perf_counter() - t0))
    losses = {p: [v.item() for v in ls] for p, ls in losses.items()}
    for path in ("kernel", "plain"):
        log(f"{name} {path} path losses: " + ", ".join(f"{v:.4f}" for v in losses[path]))
        if not all(torch.isfinite(torch.tensor(losses[path]))):
            raise AssertionError(f"{name}: non-finite loss on the {path} path")
        if steps >= 10 and not losses[path][-1] < losses[path][0]:
            raise AssertionError(f"{name}: the loss did not fall on the {path} path")
    med = {p: statistics.median(t) for p, t in times.items()}
    rates = {p: batch / (m / 1e3) for p, m in med.items()}
    for path in ("kernel", "plain"):
        log(f"train {name} bf16 B={batch} {image}px, {path} path: {rates[path]:.1f} img/s "
            f"(step median {med[path]:.4f} ms over {len(times[path])} steps)")
    out = dict(launches=launches, peak_gib=peak, losses=losses, train_img_per_s=rates,
               step_ms=med, **agreement)
    if not profile:
        return out

    counts, busy = {}, {}
    for path in ("kernel", "plain"):
        path_counts = {}
        busy[path] = breakdown(torch, f"{name} train {path}",
                               lambda: step[path](states[path], images, masks), med[path],
                               path_counts)
        if path == "kernel":
            counts = {g: sum(c for kname, c in path_counts.items() if f"{g}_kernel" in kname)
                      for g in K7_GRIDS}
    log(f"profiler: {counts} K7 grids in one {name} train step")
    if counts != dict.fromkeys(K7_GRIDS, passes):
        raise AssertionError(f"profiler saw K7 grids {counts}, expected {passes} each")

    # The recorded step is one kernel-path step from the seeded initial
    # weights, on a fresh copy of the model, not a step of the model trained
    # above: K7's backward sums with atomics, so a state reached by many steps
    # differs from run to run, and so did the axis-pass readings (the bf16
    # module chain read 2.751e-2 and 6.419e-2 on one code). The seed and the
    # batch fix every recorded state and projection, and recording_blocks
    # draws each pass's incoming gradient from a seed.
    fresh = create_model(name, dtype=torch.bfloat16, seed=0, image_size=image)
    fresh_state, fresh_step = create_train_state(fresh), make_train_step(fresh)
    readings, records = [], []
    kernel = k7.fused_axial_train
    k7.fused_axial_train = checked_k7(torch, readings)
    blocks = recording_blocks(torch, fresh.module, records)
    try:
        fresh_step(fresh_state, images, masks)
        torch.cuda.synchronize()
    finally:
        k7.fused_axial_train = kernel
        for attn in blocks:
            del attn.train_core
    worst = {k: max(r[k] for r in readings) for k in K7_OUTPUTS}
    top = max(worst, key=worst.get)
    log(f"{name}: {len(readings)} K7 launches of a train step against the plain version on the "
        f"model's operands and incoming gradients: largest reading {worst[top]:.3e} ({top}; "
        f"limit {K7_SHARE:.0e}); " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    if len(readings) != passes or not worst[top] <= K7_SHARE:
        raise AssertionError(f"{name}: K7 disagrees with its plain version in training")
    if len(records) != passes:
        raise AssertionError(f"{name}: {len(records)} axis passes recorded, expected {passes}")
    return dict(out, profiler_grids=counts, device_busy_ms=busy, launch_readings_max=worst,
                axis_passes=check_train_blocks(torch, name, records))


def flat_buffers(torch, module):
    """Every running statistic of ``module``, flattened into one float32 vector."""
    return torch.cat([b.float().flatten() for n, b in module.named_buffers() if "running" in n])


def direction_readings(torch, grads, ref):
    """Gradients (float32 tensors by parameter name) against ``ref`` as
    directions: the rel L2 between unit vectors, over all tensors that are
    nonzero in both (``all``), per tensor (the ``median`` and the three
    largest). Unit vectors 2 apart point opposite ways, sqrt(2) apart are
    orthogonal."""
    unit = lambda t: t / t.norm()
    names = [n for n in ref if n in grads and ref[n].norm() > 0 and grads[n].norm() > 0]
    flat = lambda g: unit(torch.cat([g[n].flatten() for n in names]))
    per = {n: (unit(grads[n]) - unit(ref[n])).norm().item() for n in names}
    return dict(all=(flat(grads) - flat(ref)).norm().item(),
                median=statistics.median(per.values()),
                largest=dict(sorted(per.items(), key=lambda kv: -kv[1])[:3]))


def show_directions(r):
    return (f"rel L2 {r['all']:.3e}, median over tensors {r['median']:.3e}, largest "
            + ", ".join(f"{n} {v:.2e}" for n, v in r["largest"].items()))


def grad_noise(torch, device, batch, image, layers=None):
    """Where the bf16 train-mode gradient of random-weight ``gated`` stands.
    One forward and backward (no update) on a seeded batch, float32 on the
    module path as the reference; against it, as directions: float32 on the
    same weights rounded to bf16 (a perturbation of the size of bf16
    rounding, with no bf16 arithmetic), the bf16 module path and the bf16
    kernel path (K7). ``layers`` replaces the registry's depth."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.data import prepare_images, prepare_masks
    from unet_zoo_tpu_torch.models.medt_net import ResAxialAttentionUNet
    from unet_zoo_tpu_torch.nn import init_weights
    from unet_zoo_tpu_torch.train import multi_output_loss

    images, masks = train_batch(torch, torch.Generator(device=device).manual_seed(1), batch,
                                image, device)

    def grads(dtype, use_kernels, rounded=False):
        model = create_model("gated", dtype=dtype, seed=0, image_size=image, device=device,
                             use_kernels=use_kernels)
        module = model.module
        if layers is not None:
            module = ResAxialAttentionUNet(mode="gated", layers=layers, img_size=image,
                                           dtype=dtype, use_kernels=use_kernels)
            init_weights(module, torch.Generator().manual_seed(0))
            module = module.to(device=device, memory_format=torch.channels_last)
        if rounded:
            with torch.no_grad():
                for p in module.parameters():
                    p.copy_(p.to(torch.bfloat16))
        module.train()
        multi_output_loss(module(prepare_images(images)), prepare_masks(masks),
                          model.loss_weight).backward()
        return {n: p.grad.float() for n, p in module.named_parameters()
                if p.dim() > 0 and p.grad is not None}

    ref = grads(torch.float32, False)
    out = {}
    for label, args in (("f32 on bf16-rounded weights", (torch.float32, False, True)),
                        ("bf16 module path", (torch.bfloat16, False)),
                        ("bf16 kernel path", (torch.bfloat16, True))):
        out[label] = direction_readings(torch, grads(*args), ref)
        log(f"gated {image}px B={batch} layers {layers or 'registry'}, gradient directions "
            f"against float32: {label} {show_directions(out[label])}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def seeded_gradient(torch, g, seed):
    """A gradient drawn from ``seed`` in ``g``'s shape, type and device, at
    ``g``'s scale (its rms rounded to a power of two, so the last bits of
    ``g`` do not reach it)."""
    import math

    rms = g.float().pow(2).mean().sqrt().item()
    scale = 2.0 ** round(math.log2(rms)) if rms > 0 else 1.0
    gen = torch.Generator(device=g.device).manual_seed(seed)
    return (torch.randn(g.shape, generator=gen, device=g.device) * scale).to(g.dtype)


def recording_blocks(torch, module, records):
    """Has every positional AxialAttention of ``module`` append to
    ``records``, at each train pass, a copy of itself as it was before the
    pass (weights and running statistics), its bf16 projections and an
    incoming gradient drawn from the pass's index at the scale of the one
    that reaches its output (seeded_gradient). The gradient that reaches it
    carries the last bits of the atomic sums in the backward of later layers
    (K7's, the bilinear upsample's), and with them the check's readings
    moved by 5% between two runs; a seeded one makes the operands of every
    pass the same in every run. Returns the blocks; ``del block.train_core``
    undoes it."""
    import copy

    from unet_zoo_tpu_torch.models.medt_net import AxialAttention

    blocks = [m for m in module.modules() if isinstance(m, AxialAttention) and m.mode != "wopos"]
    for attn in blocks:
        def train_core(qkv, attn=attn, core=attn.train_core):
            rec = dict(block=copy.deepcopy(attn), qkv=qkv.detach())
            del rec["block"].train_core
            out = core(qkv)
            seed = len(records)
            out.register_hook(
                lambda g: rec.__setitem__("grad", seeded_gradient(torch, g.detach(), seed)))
            records.append(rec)
            return out

        attn.train_core = train_core
    return blocks


def block_chain(torch, rec, fn, dtype):
    """One recorded axis pass run again from its recorded state, on its own
    projections and incoming gradient, by ``fn`` (``train_core``: the train
    kernel path; ``core``: the module path) computing in ``dtype``: the
    output, the gradients of the projections and of BLOCK_PARAMS, and the
    batch statistics behind the running statistics' update, by name and
    part: bn_similarity's per term (qk, qr, kr), bn_output's per sv and sve
    channels (their scales differ tenfold and more)."""
    import copy

    blk = copy.deepcopy(rec["block"])
    blk.dtype = dtype
    bns = {n: m for n, m in blk.named_children() if n.startswith("bn_")}
    before = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in bns.items()}
    params = dict(blk.named_parameters())
    x = rec["qkv"].to(dtype).requires_grad_()
    out = getattr(blk, fn)(x)
    grads = torch.autograd.grad(out, [x] + [params[n] for n in BLOCK_PARAMS],
                                rec["grad"].to(out.dtype))
    r = dict(out=out.detach(), d_qkv=grads[0],
             **{f"d_{n}": g for n, g in zip(BLOCK_PARAMS, grads[1:])})
    for n, m in bns.items():
        for stat, b, b0 in (("mean", m.running_mean, before[n][0]),
                            ("var", m.running_var, before[n][1])):
            batch = (b - (1 - m.momentum) * b0) / m.momentum
            parts = ({"": batch} if n == "bn_qkv" else
                     dict(zip(("qk", "qr", "kr"), batch.reshape(3, -1))) if n == "bn_similarity"
                     else {"sv": batch[0::2], "sve": batch[1::2]})
            r.update({f"{n} batch {stat} {part}".strip(): t for part, t in parts.items()})
    return r


def block_faults(torch, rec, ref):
    """The train kernel chain of one recorded pass with a fault planted each:
    K7's sve dropped; the kr gate dropped (kg = k: train-mode BatchNorm
    normalises the scale away, so only the running statistics show it);
    bf16 BatchNorm normalising with the running statistics (a fault of the
    BatchNorm helper in bf16 only). Returns each fault's largest reading
    against the float32 module chain ``ref``."""
    import torch.nn.functional as F

    from unet_zoo_tpu_torch.models import medt_net
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7

    kernel, bn_last = k7.fused_axial_train, medt_net._bn_last

    def no_sve(*a):
        sv, sve, mu, var = kernel(*a)
        return sv, torch.zeros_like(sve), mu, var

    def running_bn(t, bn):
        if t.dtype != torch.bfloat16:
            return bn_last(t, bn)
        y = F.batch_norm(t.reshape(-1, t.shape[-1]).float(), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        return y.to(t.dtype).reshape(t.shape)

    plants = {"sve dropped": (k7, "fused_axial_train", no_sve),
              "kr gate dropped": (k7, "fused_axial_train",
                                  lambda q, k, qg, kg, *a: kernel(q, k, qg, k, *a)),
              "bf16 BatchNorm on running statistics": (medt_net, "_bn_last", running_bn)}
    caught = {}
    for fault, (owner, attr, value) in plants.items():
        saved = getattr(owner, attr)
        setattr(owner, attr, value)
        try:
            got = block_chain(torch, rec, "train_core", torch.bfloat16)
        finally:
            setattr(owner, attr, saved)
        caught[fault] = max(block_readings(torch, got, ref).values())
    return caught


def block_readings(torch, got, ref):
    """Each quantity of one axis pass (block_chain) against ``ref`` by rel
    L2, but a batch mean's error over the rms of the batch's second moment
    (var + mean²): BatchNorm divides by the spread, so a mean's error counts
    at that scale, where a mean near zero would read rounding as large."""
    out = {}
    for k, r in ref.items():
        if " batch mean" in k:
            second = ref[k.replace(" mean", " var")] + r * r
            out[k] = ((got[k] - r).norm() / second.sqrt().norm()).item()
        else:
            out[k] = rel_l2(torch, got[k], r)
    return out


def check_train_blocks(torch, name, records):
    """Every positional axis pass of one train step, run again from its
    recorded state on its own bf16 projections and seeded incoming gradient
    (recording_blocks): the
    train kernel chain (``train_core``, K7) and the bf16 module chain
    (``core``) against the float32 module chain (block_readings): the
    output, the gradients of the projections and of BLOCK_PARAMS, and the
    batch statistics behind the running statistics; limit
    TRAIN_BLOCK_REL_L2. Each pass also runs the
    planted faults of block_faults, which must read above the limit.
    Returns the largest reading of each quantity on each chain and the
    smallest reading of each fault."""
    worst = {"kernel": {}, "module": {}}
    caught = {}
    for rec in records:
        ref = block_chain(torch, rec, "core", torch.float32)
        for path, fn in (("kernel", "train_core"), ("module", "core")):
            got = block_chain(torch, rec, fn, torch.bfloat16)
            for k, v in block_readings(torch, got, ref).items():
                worst[path][k] = max(worst[path].get(k, 0.0), v)
        for fault, r in block_faults(torch, rec, ref).items():
            caught[fault] = min(caught.get(fault, float("inf")), r)
        del ref, got
    for path in ("kernel", "module"):
        top = max(worst[path], key=worst[path].get)
        log(f"{name}: {len(records)} axis passes of a train step again on their own operands, "
            f"{path} chain in bf16 against the float32 module chain: largest rel L2 "
            f"{worst[path][top]:.3e} ({top}; limit {TRAIN_BLOCK_REL_L2:.0e}); "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst[path].items()))
    log(f"  planted faults, smallest over the passes: "
        + ", ".join(f"{k} {v:.3e}" for k, v in caught.items()))
    if not max(max(w.values()) for w in worst.values()) <= TRAIN_BLOCK_REL_L2:
        raise AssertionError(f"{name}: an axis pass in bf16 strays from float32: {worst}")
    if not min(caught.values()) > TRAIN_BLOCK_REL_L2:
        raise AssertionError(f"{name}: the axis-pass comparison passed a planted fault: {caught}")
    return dict(readings_max=worst, faults_min=caught)


def k7_work(n, length, g, gp, ks, moments=False):
    """K7's least work, for any implementation: (forward f32 operations,
    backward f32 operations, forward bytes, backward bytes). Per (row, group,
    i, j), c = gp/2: forward 6c (terms) + 9 (logits, softmax) + 4gp (sv,
    sve); backward 6c + 9 (sim once more) + 4gp (dsim) + 4 (dpre) + 12 (S,
    dtot) + 4gp (d_v, d_v_emb) + 12c (the q/k contractions). The moments
    need no per-pair work: per-row Gram sums give them in O(L c^2) (Σ qk^2 =
    Σ_cc' (Σ_i q_ic q_ic')(Σ_j k_jc k_jc'); qr and kr by sums along
    ``relative``'s diagonals). ``moments`` adds 9 operations per pair
    for them, as the bound was counted before. Bytes: every bf16 operand read and every output
    written once, ``relative`` and the [3, g] tables once."""
    c, pairs, nl = gp // 2, n * g * length * length, n * length * g
    tables = 4 * 2 * gp * (2 * ks - 1)
    return (pairs * (6 * c + 4 * gp + 9 + (9 if moments else 0)), pairs * (18 * c + 8 * gp + 25),
            2 * (4 * nl * c + nl * gp) + 2 * 2 * nl * gp + tables + 4 * 9 * g,
            2 * (4 * nl * c + 3 * nl * gp) + 2 * (4 * nl * c + nl * gp) + 2 * tables + 4 * 15 * g)


def time_k7(torch, gen, device):
    """K7 at each launch shape of the B=8 gated train step, both axes:
    forward (stats + fwd) and backward (bwd + fin + combine) device ms by
    CUDA graph replay (the backward as forward + backward less the forward,
    since autograd runs a backward on its forward's stream), the same
    through autograd by CUDA events back to back (what a step sees), the
    plain version's forward + backward, the bf16 module chain's forward +
    backward (the module path from bn_qkv to bn_output, what K7 replaces in
    training), the same chain on the train kernel path, and the bound (with
    the per-pair moment operations beside it)."""
    from unet_zoo_tpu_torch.models.medt_net import AxialAttention
    from unet_zoo_tpu_torch.nn import init_weights
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7

    rows, step_bytes, step_old_ops = [], 0, 0
    for s, gp, ks, blocks in AXIAL_SHAPES:
        for width_axis in (False, True):
            b, g = SERVE_BATCH, AXIAL_GROUPS
            ops, cts = k7_operands(torch, gen, b, s, s, gp, ks, width_axis, device)
            leaves = [t.detach().requires_grad_() for t in ops]
            fwd = lambda: k7.fused_axial_train(*leaves, ks)
            fwd_ms = graph_ms(torch, fwd, 10)
            bwd_ms = graph_ms(torch, lambda: torch.autograd.grad(fwd()[:2], leaves, cts),
                              10) - fwd_ms
            ev_fwd_ms = cuda_ms(torch, fwd, 10)
            outs = fwd()
            ev_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(outs[:2], leaves, cts,
                                                                   retain_graph=True), 10)
            plain_ms = cuda_ms(torch, lambda: k7_reference(torch, ops, cts, ks), 2)
            attn = AxialAttention(g * gp, g * gp, g, ks, width_axis=width_axis, mode="gated",
                                  dtype=torch.bfloat16)
            init_weights(attn, torch.Generator().manual_seed(s + gp))
            attn = attn.to(device).train()
            n = b * s
            tokens = torch.randn(n, s, 2 * g * gp, generator=gen, device=device).to(
                torch.bfloat16).requires_grad_()
            ct = torch.randn(n, s, g * gp, generator=gen, device=device).to(torch.bfloat16)
            chain = lambda core: torch.autograd.grad(core(tokens), [tokens, attn.relative], ct)
            chain_ms = cuda_ms(torch, lambda: chain(attn.core), 5)
            kchain_ms = cuda_ms(torch, lambda: chain(attn.train_core), 10)
            fwd_ops, bwd_ops, fwd_bytes, bwd_bytes = k7_work(n, s, g, gp, ks)
            bound_ms, bound_by = bound(0, fwd_bytes + bwd_bytes, fwd_ops + bwd_ops)
            old_ops = k7_work(n, s, g, gp, ks, moments=True)[0] + bwd_ops
            step_bytes += blocks * (fwd_bytes + bwd_bytes)
            step_old_ops += blocks * old_ops
            axis = "W" if width_axis else "H"
            rows.append(dict(n=n, length=s, gp=gp, kernel_size=ks, axis=axis, launches=blocks,
                             fwd_ms=fwd_ms, bwd_ms=bwd_ms, ms=fwd_ms + bwd_ms,
                             autograd_fwd_ms=ev_fwd_ms, autograd_bwd_ms=ev_bwd_ms,
                             autograd_ms=ev_fwd_ms + ev_bwd_ms,
                             f32_ops=fwd_ops + bwd_ops, bytes=fwd_bytes + bwd_bytes,
                             fwd_bound_ms=bound(0, fwd_bytes, fwd_ops)[0],
                             bwd_bound_ms=bound(0, bwd_bytes, bwd_ops)[0],
                             bound_ms=bound_ms, bound_by=bound_by,
                             plain_ms=plain_ms, module_chain_ms=chain_ms,
                             kernel_chain_ms=kchain_ms))
            log(f"K7 N={n} L={s} gp={gp} along {axis} x{blocks}: device (graph) fwd "
                f"{fwd_ms:.4f} + bwd {bwd_ms:.4f} ms, through autograd {ev_fwd_ms:.4f} + "
                f"{ev_bwd_ms:.4f} ms (bound {rows[-1]['fwd_bound_ms']:.4f} + "
                f"{rows[-1]['bwd_bound_ms']:.4f}, {bound_by}; with per-pair moments "
                f"{bound(0, fwd_bytes + bwd_bytes, old_ops)[0]:.4f}), plain {plain_ms:.4f} ms, "
                f"module chain {chain_ms:.4f} ms, kernel chain {kchain_ms:.4f} ms")
            del outs, leaves, attn, tokens
            torch.cuda.empty_cache()
    log(f"K7 bound per step with per-pair moments (as counted before per-row Gram sums): "
        f"{bound(0, step_bytes, step_old_ops)[0]:.4f} ms")
    return rows


def k2_case(torch, gen, b_, nh, n, hd, nw, device):
    """Random K2 operands at one launch shape: q, k and v as views of one
    bf16 [B_, N, 3, nh, hd] projection (the model's layout), with an all-zero
    q row and k row (the 1e-6 clamp); tau from U(0.005, 0.1), so some
    entries lie below the 0.01 clip; a bias of a few units; a random
    0 / -100 mask of nW windows, None for nW 1."""
    qkv = torch.randn(b_, n, 3, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    qkv[0, 1, 0, 0] = 0.0
    qkv[0, 2, 1, 0] = 0.0
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    tau = 0.005 + 0.095 * torch.rand(nh, n, n, generator=gen, device=device)
    bias = 3.0 * torch.randn(nh, n, n, generator=gen, device=device)
    mask = None
    if nw > 1:
        drop = torch.rand(nw, n, n, generator=gen, device=device) < 0.3
        mask = torch.where(drop, -100.0, 0.0)
    return q, k, v, tau, bias, mask


def mask_by_image(torch, mask, b_):
    """The mask as window b would read it at ``mask[b // nW]``: by image, not
    by window (expanded to one mask per window)."""
    nw = mask.shape[0]
    return mask[(torch.arange(b_, device=mask.device) // nw) % nw]


def k2_faults(torch, q, k, v, tau, bias, mask):
    """K2's plain version (f32) with one fault planted each: the bias table
    transposed, the mask read by image (where there is a mask), tau
    unclipped (``_clip_tau`` redirected for that one call) and the softmax
    over the queries (``torch.softmax`` redirected)."""
    from unet_zoo_tpu_torch.ops.kernels import window_attention as k2

    plain = k2.swin_window_attention_reference
    faults = [("bias transposed", plain(q, k, v, tau, bias.transpose(1, 2).contiguous(), mask))]
    if mask is not None:
        faults.append(("mask by image", plain(q, k, v, tau, bias, mask_by_image(torch, mask,
                                                                                  q.shape[0]))))
    clip, softmax = k2._clip_tau, torch.softmax
    k2._clip_tau = lambda t: t.float()
    try:
        faults.append(("tau unclipped", plain(q, k, v, tau, bias, mask)))
    finally:
        k2._clip_tau = clip
    torch.softmax = lambda t, dim: softmax(t, dim=-2)
    try:
        faults.append(("softmax over queries", plain(q, k, v, tau, bias, mask)))
    finally:
        torch.softmax = softmax
    return faults


def check_k2(torch, gen, device):
    """K2 against its plain version (f32 on the same bf16 operands) at every
    launch shape of both served swin_unet_v2 configurations, which must run
    the mma instance, and at odd shapes of both instances, each beside the
    planted faults that the same comparison must reject (on the mma
    instance also the source's own); the mma plan against the source's
    numbers. Returns the max abs error."""
    from unet_zoo_tpu_torch.ops.kernels import window_attention as k2

    bf = torch.bfloat16
    cases = [(f"{image}px window {window}", *shape[:5], bf, "mma") for image, window in SWIN_CONFIGS
             for shape in k2.launch_shapes(image, window, SERVE_BATCH)]
    cases += [("odd shape", 6, 5, 49, 16, 3, bf, "mma"), ("odd shape", 10, 4, 36, 32, 2, bf, "mma"),
              ("odd shape", 4, 2, 100, 24, 2, bf, "general"),
              ("float32", 64, 3, 49, 32, 64, torch.float32, "general")]
    err = 0.0
    for where, b_, nh, n, hd, nw, dtype, want in cases:
        args = k2_case(torch, gen, b_, nh, n, hd, nw, device)
        args = [args[0].to(dtype), args[1].to(dtype), args[2].to(dtype), *args[3:]]
        which = k2.instance(*args[:3])
        if which != want:
            raise AssertionError(f"K2 at {where} B_={b_} N={n} hd={hd} runs {which}, not {want}")
        got = k2.swin_window_attention(*args)
        f32 = [args[0].float(), args[1].float(), args[2].float(), *args[3:]]
        ref = k2.swin_window_attention_reference(*f32)
        caught = {name: k6_reading(out, ref) for name, out in k2_faults(torch, *f32)}
        plan = ""
        if which == "mma":
            p = k2.plan(b_, nh, n, hd, nw)
            source = k2.source_geometry(b_, nh, hd, nw, nw > 1, p.windows_per_block)
            if source != (p.grid, p.threads, p.smem, p.per_group, p.chunks):
                raise AssertionError(f"K2's plan {p} is not the source's {source}")
            plan = f", {p.windows_per_block} windows a block, {p.grid} blocks"
            for name in k2.FAULTS:
                if nw > 1 or name != "one mask a block":
                    caught[name] = k6_reading(k2.planted_fault(name, *args), ref)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        reading = k6_reading(got, ref)
        e = (got.float() - ref).abs().max().item()
        log(f"K2 {where}: B_={b_} nh={nh} N={n} hd={hd} nW={nw} {dtype} on {which}{plan}: "
            f"max_abs_err {e:.3e}; beyond output rounding {reading:.3e} of the output rms (limit "
            f"{K2_SHARE:.0e}); planted faults " + ", ".join(f"{k} {v:.3e}" for k, v in caught.items()))
        if not reading <= K2_SHARE:
            raise AssertionError(f"K2 disagrees with its plain version: {reading}")
        if not min(caught.values()) > K2_SHARE:
            raise AssertionError(f"the K2 comparison passed a planted fault: {caught}")
        err = max(err, e)
    return err


def sharpen_swin(torch, module, tau_range=SWIN_TAU):
    """Sharper attention than at init (tau 1, a CPB bias of about 0.25): tau
    drawn from U(``tau_range``) and each ``cpb.fc2`` scaled so that its CPB
    table has std 2. Every model built from the same seed gets the same
    values (its own CPU generator)."""
    from unet_zoo_tpu_torch.models.swin_unet_v2 import WindowAttentionV2

    lo, hi = tau_range
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, WindowAttentionV2):
                m.tau.copy_(lo + (hi - lo) * torch.rand(m.tau.shape, generator=g))
                m.cpb.fc2.weight.mul_(2.0 / m.cpb_bias(torch.float32).std())


def swin_faults(torch, name, preds, x, refs, rel_l2_max):
    """K2 inside the served bf16 model: every launch of a forward held
    against K2's plain version on the same operands, the model's own
    activations (k6_reading, limit K2_SHARE). Then faults planted into K2's
    arguments, each through the real kernel on every launch that has the
    term: q and k swapped, the bias table transposed and, in the shifted
    blocks, the mask read by image. Each forward is read against the plain
    path and launch by launch; every fault must fail at least one check.
    Returns the readings."""
    from unet_zoo_tpu_torch.ops.kernels import window_attention as k2

    kernel = k2.swin_window_attention
    dist = lambda a, b: ((a - b).norm() / b.norm()).item()
    mask = lambda t: torch.sigmoid(t) > 0.5
    faults = {
        "none": None,
        "q and k swapped": lambda q, k, v, tau, bias, m: (k, q, v, tau, bias, m),
        "bias transposed": lambda q, k, v, tau, bias, m: (
            q, k, v, tau, bias.transpose(1, 2).contiguous(), m),
        "mask by image": lambda q, k, v, tau, bias, m: (
            q, k, v, tau, bias, None if m is None else mask_by_image(torch, m, q.shape[0])),
    }

    def checked(plant, passes):
        def launch(*a):
            got = kernel(*(a if plant is None else plant(*a)))
            f32 = [a[0].float(), a[1].float(), a[2].float(), *a[3:]]
            passes.append(k6_reading(got, k2.swin_window_attention_reference(*f32)))
            return got
        return launch

    readings = {}
    try:
        for fault, plant in faults.items():
            passes = []
            k2.swin_window_attention = checked(plant, passes)
            lk = preds["kernel"](x).float()
            k2.swin_window_attention = kernel
            r = dict(rel_l2=dist(lk, refs["plain"]),
                     mask_agreement=(mask(lk) == mask(refs["plain"])).float().mean().item(),
                     launch_reading_max=max(passes))
            failed = [k for k, bad in (("rel_l2", r["rel_l2"] > rel_l2_max),
                                       ("mask_agreement", r["mask_agreement"] < SWIN_AGREE),
                                       ("launch_reading", r["launch_reading_max"] > K2_SHARE))
                      if bad]
            readings[fault] = dict(r, failed=failed)
            log(f"{name} planted fault {fault}: rel L2 vs plain {r['rel_l2']:.3e} (<= "
                f"{rel_l2_max:.0e}), mask agreement {r['mask_agreement']:.5f} (>= {SWIN_AGREE}), "
                f"its {len(passes)} K2 launches against the plain version at most "
                f"{r['launch_reading_max']:.3e} (<= {K2_SHARE:.0e}): fails {failed or 'nothing'}")
    finally:
        k2.swin_window_attention = kernel
    if readings["none"]["failed"]:
        raise AssertionError(f"{name}: K2 disagrees with its plain version in the served model")
    passed = [f for f, r in readings.items() if f != "none" and not r["failed"]]
    if passed:
        raise AssertionError(f"{name}: the served-model checks passed planted faults {passed}")
    return readings


def serve_swin(torch, gen, device, image, window):
    """Registry-default swin_unet_v2 at ``image`` px, window ``window``, bf16,
    B=8, on both paths with sharpened attention: one K2 launch per block by
    the counter and by the profiler, agreement, planted faults, rates and
    the device-time breakdown."""
    from unet_zoo_tpu_torch.ops.kernels import window_attention as k2

    name = f"swin_unet_v2 {image}px window {window}"
    preds, x, counts, agreement, refs = serve_both_paths(
        torch, gen, device, "swin_unet_v2", SERVE_BATCH, image,
        [(k2, "swin_window_attention"), (k2, "swin_window_attention_mma")],
        SWIN_REL_L2, SWIN_AGREE, SWIN_F32_RATIO, prepare=lambda m: sharpen_swin(torch, m),
        window_size=window)
    launches = counts["swin_window_attention"]
    if launches != SWIN_LAUNCHES or counts["swin_window_attention_mma"] != SWIN_LAUNCHES:
        raise AssertionError(f"K2 ran {counts} times in {name}, expected {SWIN_LAUNCHES} on "
                             f"the mma instance")
    faults = swin_faults(torch, name, preds, x, refs, SWIN_REL_L2)
    events = profile_forward(torch, lambda: preds["kernel"](x))
    seen = sum(K2_GRID in e.name for e in events)
    log(f"profiler: {seen} {K2_GRID} grids in one {name} forward")
    if seen != SWIN_LAUNCHES:
        raise AssertionError(f"profiler saw K2 {seen} times in {name}, expected {SWIN_LAUNCHES}")
    rates, med, busy = time_paths(torch, name, preds, x, profile=True)
    return dict(image=image, window=window, launches=launches, profiler_grids=seen,
                serve_img_per_s=rates, forward_ms=med, device_busy_ms=busy,
                planted_faults=faults, sharper=sharper_paths(torch, x, image, window),
                **agreement)


def sharper_paths(torch, x, image, window):
    """Reported, no limit: the two bf16 paths and float32 compute with tau
    from U(SWIN_TAU_SHARPER). Cosines over tau that small set near one-hot
    attention whose choice a bf16 rounding flips, so the paths part."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.utils.serving import make_predictor

    logits = {}
    for path, kw in (("kernel", dict(dtype=torch.bfloat16)),
                     ("plain", dict(dtype=torch.bfloat16, use_kernels=False)),
                     ("f32", dict(use_kernels=False))):
        model = create_model("swin_unet_v2", seed=0, image_size=image, window_size=window, **kw)
        sharpen_swin(torch, model.module, SWIN_TAU_SHARPER)
        logits[path] = make_predictor(model, None, "logits")(x).float()
    dist = lambda a, b: ((logits[a] - logits[b]).norm() / logits[b].norm()).item()
    r = dict(tau=SWIN_TAU_SHARPER, rel_l2=dist("kernel", "plain"),
             mask_agreement=((logits["kernel"] > 0) == (logits["plain"] > 0)).float().mean().item(),
             rel_l2_to_f32={p: dist(p, "f32") for p in ("kernel", "plain")})
    log(f"swin_unet_v2 {image}px, tau from U{SWIN_TAU_SHARPER} (reported): rel L2 kernel vs "
        f"plain {r['rel_l2']:.3e}, mask agreement {r['mask_agreement']:.5f}; rel L2 to f32 "
        f"compute: kernel {r['rel_l2_to_f32']['kernel']:.3e}, plain {r['rel_l2_to_f32']['plain']:.3e}")
    return r


def time_k2(torch, gen, device, image, window):
    """K2 at each launch shape of one B=8 forward: kernel, plain version,
    bound, and the bf16 module chain it replaces (``attend``: the module
    path from q, k, v to the attention output, CPB MLP included) on a
    sharpened bf16 WindowAttentionV2 with bf16-rounded parameters."""
    from unet_zoo_tpu_torch.models.swin_unet_v2 import WindowAttentionV2, _shift_attn_mask
    from unet_zoo_tpu_torch.nn import init_weights
    from unet_zoo_tpu_torch.ops.kernels import window_attention as k2
    from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference

    rows = []
    for b_, nh, n, hd, nw, blocks in k2.launch_shapes(image, window, SERVE_BATCH):
        w = int(round(n ** 0.5))
        attn = WindowAttentionV2(nh * hd, (w, w), nh, dtype=torch.bfloat16, use_kernels=False)
        init_weights(attn, torch.Generator().manual_seed(b_ + nh))
        sharpen_swin(torch, attn)
        attn = cast_params_for_inference(attn).to(device).eval()
        tau, bias = attn.kernel_tables()
        res = w * int(round(nw ** 0.5))
        mask = (torch.from_numpy(_shift_attn_mask(res, res, w, w // 2)).to(device)
                if nw > 1 else None)
        q, k, v = (torch.randn(b_, n, nh, hd, generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(3))
        qs, kt, vt = (q * attn.scale).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        with torch.inference_mode():
            kernel = lambda: k2.swin_window_attention(qs, kt, vt, tau, bias, mask)
            ms = cuda_ms(torch, kernel, 20)
            by_graph = graph_ms(torch, kernel, 20)
            plain_ms = cuda_ms(torch, lambda: k2.swin_window_attention_reference(
                qs, kt, vt, tau, bias, mask), 5)
            chain_ms = cuda_ms(torch, lambda: attn.attend(q, k, v, mask), 20)
        tc, f32, nbytes = k2.work(b_, nh, n, hd, nw)
        bound_ms, bound_by = bound(tc, nbytes, f32)
        rows.append(dict(image=image, window=window, windows=b_, heads=nh, tokens=n, head_dim=hd,
                         mask_windows=nw, launches=blocks, tc_flops=tc, f32_ops=f32,
                         bytes=nbytes, ms=ms, graph_ms=by_graph, plain_ms=plain_ms,
                         module_chain_ms=chain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         instance=k2.instance(qs, kt, vt)))
        log(f"K2 {image}px B_={b_} nh={nh} N={n} hd={hd} nW={nw} x{blocks}: {ms:.4f} ms by "
            f"events, {by_graph:.4f} ms by graph, plain {plain_ms:.4f} ms, module chain "
            f"{chain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{nbytes / by_graph / 1e6:.1f} GB/s by graph)")
    return rows


def ulp_reading(got, ref):
    """K3's and K8's error against a plain version that also rounds to bf16
    once: max over elements of (|got - ref| - 2^-7 |ref|) / rms(ref), what
    lies beyond one bf16 ulp, as a share of the output."""
    excess = (got.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
    return (excess.max() / ref.float().pow(2).mean().sqrt()).item()


def unext_launch_shapes(name, image=IMAGE, batch=SERVE_BATCH):
    """K3's launch shapes in one forward of registry-default ``name``: rows of
    (B, H, W, C, launches), C the MLP's hidden width 4 x dim at stage s's
    resolution image / 2^(s + 2)."""
    dims, depths = UNEXT_CONFIGS[name]
    return [(batch, image >> (s + 2), image >> (s + 2), 4 * d, n)
            for s, (d, n) in enumerate(zip(dims, depths))]


def k3_work(b, h, w, c, k=3):
    """K3: (f32 operations, least bytes): 2 k^2 operations per output
    element; x read and the output written once (bf16), the bf16 taps and
    bias once."""
    return 2 * k * k * b * h * w * c, 2 * (2 * b * h * w * c + k * k * c + c)


def k3_case(torch, gen, b, h, w, c, k, device, dtype=None):
    """K3 operands (bf16 unless ``dtype``): x, a [k, k, C] kernel of O(1 / k)
    taps, a bias."""
    dtype = torch.bfloat16 if dtype is None else dtype
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    return r(b, h, w, c).to(dtype), (r(k, k, c) / k).to(dtype), r(c).to(dtype)


def k3_halo_displaced(torch, x, kern, bias, th=8, tw=16):
    """K3's plain version as a kernel whose tiles (th x tw: the general
    instance's 8 x 16, or the stream instance's bands and strips) read their
    halo one pixel further into the neighbouring tile's interior."""
    b, h, w, c = x.shape
    k = kern.shape[0]
    p = (k - 1) // 2

    def source(n, t):
        i = torch.arange(n, device=x.device)[:, None]
        src = i + torch.arange(k, device=x.device)[None, :] - p
        lo = (i // t) * t
        src = torch.where(src < lo, src - 1, torch.where(src >= lo + t, src + 1, src))
        return src.clamp(0, n - 1), (src >= 0) & (src < n)

    (ry, vy), (rx, vx) = source(h, th), source(w, tw)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    xf = x.float()
    for dy in range(k):
        for dx in range(k):
            ok = (vy[:, dy][:, None] & vx[:, dx][None, :])[None, :, :, None]
            tap = xf[:, ry[:, dy]][:, :, rx[:, dx]]
            acc = acc + torch.where(ok, tap, 0.0) * kern[dy, dx].float()
    return (acc + bias.float()).to(x.dtype)


def k3_fault_layout(k3, x):
    """The stream layout the planted faults run on: plan()'s, with bands of
    half the image where the plan has one band, so that a band has a
    neighbour to read its halo from."""
    b, h, w, c = x.shape
    p = k3.plan(b, h, w, c)
    return p if p.bands > 1 else k3.layout(b, h, w, c, p.lcv, max(1, h // 2), p.ring)


def check_k3(torch, gen, device, shapes=None):
    """K3 against its plain version (the same operands) at every distinct
    launch shape of unext and unext_s at B=8/256px and an odd shape (odd H
    and W, C 24), all on the stream instance, and on the general instance at
    odd shapes (C 20, k 5; float32, C 37), or at ``shapes`` ([B, H, W, C] on
    the stream instance) where given, each beside planted faults that
    the same comparison must reject: the taps transposed, the halo read one
    pixel into the neighbouring tile (the instance's own geometry: the
    stream instance's bands and strips, the general one's 8 x 16 tiles), the
    bias dropped, and on the stream instance the source's design faults (a
    band's halo rows from the neighbouring band, each row from the ring slot
    of the row before it). Every case runs twice, bit for bit. Returns the
    max abs error."""
    from unet_zoo_tpu_torch.ops.kernels import depthwise as k3

    if shapes is not None:
        cases = [(*shape, 3, "stream") for shape in shapes]
    else:
        cases = sorted({(*row[:4], 3, "stream") for name in UNEXT_CONFIGS
                        for row in unext_launch_shapes(name)})
        cases += [(2, 37, 45, 24, 3, "stream"), (2, 37, 45, 20, 5, "general"),
                  (1, 9, 7, 37, 3, "general f32")]
    err = 0.0
    for b, h, w, c, k, which in cases:
        dtype = torch.float32 if which.endswith("f32") else torch.bfloat16
        x, kern, bias = k3_case(torch, gen, b, h, w, c, k, device, dtype)
        assert k3.instance(x, kern) == which.split()[0]
        before = dict(k3.LAUNCHES)
        got = k3.depthwise_conv2d(x, kern, bias)
        key = f"depthwise_conv2d_{which.split()[0]}"
        if k3.LAUNCHES[key] - before[key] != 1:
            raise AssertionError(f"K3 [{b}, {h}, {w}, {c}] did not run the {which} instance")
        ref = k3.depthwise_conv2d_reference(x, kern, bias)
        if which == "stream":
            p = k3_fault_layout(k3, x)
            faults = {name: k3.planted_fault(name, x, kern, bias, p) for name in k3.FAULTS}
            faults["halo from the neighbour's interior"] = k3_halo_displaced(
                torch, x, kern, bias, p.bh, p.tw)
            geometry = (f"plan bands of {k3.plan(b, h, w, c).bh} rows, strips of "
                        f"{p.tw}, chunks of {8 * p.cv}, ring {p.ring}")
        else:
            faults = {"halo from the neighbour's interior": k3_halo_displaced(
                torch, x, kern, bias)}
            geometry = "8 x 16 tiles"
        faults["taps transposed"] = k3.depthwise_conv2d_reference(
            x, kern.transpose(0, 1).contiguous(), bias)
        faults["bias dropped"] = k3.depthwise_conv2d_reference(x, kern)
        caught = {name: ulp_reading(out, ref) for name, out in faults.items()}
        again = k3.depthwise_conv2d(x, kern, bias)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        reading = ulp_reading(got, ref)
        e = (got.float() - ref.float()).abs().max().item()
        log(f"K3 [{b}, {h}, {w}, {c}] k={k} {which} instance ({geometry}): max_abs_err "
            f"{e:.3e}; beyond one bf16 ulp {reading:.3e} of the output rms (limit "
            f"{K3_SHARE:.0e}); least planted fault {min(caught.values()):.3e} "
            f"({min(caught, key=caught.get)}); twice bit for bit {torch.equal(got, again)}")
        if not reading <= K3_SHARE:
            raise AssertionError(f"K3 disagrees with its plain version: {reading}")
        if not min(caught.values()) > K3_SHARE:
            raise AssertionError(f"the K3 comparison passed a planted fault: {caught}")
        if not torch.equal(got, again):
            raise AssertionError(f"K3 [{b}, {h}, {w}, {c}] differs between two launches")
        err = max(err, e)
    return err


def checked_launches(torch, module, attr, reference, fn):
    """Run ``fn()`` with every launch of ``module.attr`` (a kernel wrapper)
    also held against ``reference`` on the same operands (ulp_reading);
    returns (fn's result, the readings)."""
    kernel = getattr(module, attr)
    readings = []

    def launch(*a):
        got = kernel(*a)
        readings.append(ulp_reading(got, reference(*a)))
        return got

    setattr(module, attr, launch)
    try:
        return fn(), readings
    finally:
        setattr(module, attr, kernel)


def serve_k3_carrier(torch, gen, device, name, image, want, rel_l2_max, agree_min, f32_ratio):
    """Registry-default ``name`` in bf16 at B=8 and ``image`` on both paths:
    ``want`` K3 launches a forward on its stream instance by the counter and
    by the profiler, every K3 launch of the served forward against its plain
    version on its own operands, agreement, rates, the device-time
    breakdown, idle share and peak memory of one kernel-path forward, and
    each Switch-MoE block's dropped share in the served module's last
    kernel-path forward (none in missformer)."""
    from unet_zoo_tpu_torch.ops.kernels import depthwise as k3

    preds, x, launches, agreement, _ = serve_both_paths(
        torch, gen, device, name, SERVE_BATCH, image,
        [(k3, "depthwise_conv2d"), (k3, "depthwise_conv2d_stream")],
        rel_l2_max, agree_min, f32_ratio)
    stream = launches["depthwise_conv2d_stream"]
    launches = launches["depthwise_conv2d"]
    if launches != want or stream != want:
        raise AssertionError(f"K3 ran {launches} times in {name}, {stream} on the stream "
                             f"instance, expected {want}")
    _, readings = checked_launches(torch, k3, "depthwise_conv2d",
                                   k3.depthwise_conv2d_reference, lambda: preds["kernel"](x))
    log(f"{name} {image}px: its {len(readings)} K3 launches against the plain version on the "
        f"model's own operands: at most {max(readings):.3e} (<= {K3_SHARE:.0e})")
    if len(readings) != want or not max(readings) <= K3_SHARE:
        raise AssertionError(f"{name}: K3 disagrees with its plain version in the served model")
    events = profile_forward(torch, lambda: preds["kernel"](x))
    seen = sum("depthwise_stream_kernel" in e.name for e in events)
    log(f"profiler: {seen} depthwise_stream_kernel grids in one {name} {image}px forward")
    if seen != want:
        raise AssertionError(f"profiler saw K3 {seen} times in {name}, expected {want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds["kernel"](x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rates, med, busy = time_paths(torch, f"{name} {image}px", preds, x, profile=True)
    idle = {path: 1 - busy[path] / med[path] for path in busy}
    preds["kernel"](x)
    drops = moe_drop_shares(preds["kernel"].module)
    log(f"serve {name} {image}px kernel path: peak {peak:.2f} GiB, idle share {idle}"
        + (f", dropped share a MoE block {drops}" if drops else ""))
    return dict(image=image, launches=launches, stream_launches=stream, profiler_grids=seen,
                launch_reading_max=max(readings), serve_img_per_s=rates, forward_ms=med,
                device_busy_ms=busy, idle_share=idle, peak_gib=peak, drop_shares=drops,
                **agreement)


def time_k3(torch, gen, device, name, shapes=None):
    """K3 at each launch shape of one B=8 forward of ``name`` (``shapes``,
    rows of (B, H, W, C, launches), where given; graph_ms: each
    launch takes less device time than its host cost): kernel, plain
    version, bound, the bf16 module chain it replaces (``DWConv``'s module
    path on the same [B, H, W, C] tokens) and cuDNN's depthwise conv
    (``F.conv2d(groups=C)`` on the channels_last view: library_ms, used
    nowhere in the port); beside them the kernel by CUDA events around 20
    back-to-back calls (``events_ms``) and the wrapper's host time a call
    (``host_us``: the wall time to issue 20 calls, median of 5)."""
    import torch.nn.functional as F

    from unet_zoo_tpu_torch.nn.transformer import DWConv
    from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
    from unet_zoo_tpu_torch.probes.window_grids import host_us

    rows = []
    for b, h, w, c, n in (shapes or unext_launch_shapes(name)):
        x, kern, bias = k3_case(torch, gen, b, h, w, c, 3, device)
        dw = DWConv(c, torch.bfloat16, use_kernels=False).to(device).eval()
        with torch.no_grad():
            dw.dwconv.weight.copy_(kern.permute(2, 0, 1)[:, None])
            dw.dwconv.bias.copy_(bias)
        weight, bias_l, xc = dw.dwconv.weight.to(torch.bfloat16), bias, x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            ms = graph_ms(torch, lambda: k3.depthwise_conv2d(x, kern, bias), 20)
            events_ms = cuda_ms(torch, lambda: k3.depthwise_conv2d(x, kern, bias), 20)
            host = host_us(lambda: k3.depthwise_conv2d(x, kern, bias), 20)
            plain_ms = graph_ms(torch, lambda: k3.depthwise_conv2d_reference(x, kern, bias), 5)
            chain_ms = graph_ms(torch, lambda: dw(x), 20)
            lib_ms = graph_ms(torch, lambda: F.conv2d(xc, weight, bias_l, padding=1, groups=c), 20)
        f32, nbytes = k3_work(b, h, w, c)
        bound_ms, bound_by = bound(0, nbytes, f32)
        rows.append(dict(model=name, b=b, h=h, w=w, c=c, launches=n, f32_ops=f32, bytes=nbytes,
                         ms=ms, events_ms=events_ms, host_us=host, plain_ms=plain_ms,
                         module_chain_ms=chain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, plan=k3.plan(b, h, w, c)._asdict()))
        log(f"K3 {name} [{b}, {h}, {w}, {c}] x{n}: {ms:.4f} ms by graph, {events_ms:.4f} ms by "
            f"events, host {host:.1f} us a call, plain {plain_ms:.4f} ms, module "
            f"chain {chain_ms:.4f} ms, cuDNN depthwise {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {nbytes / ms / 1e6:.1f} GB/s)")
    return rows


def wranet_launch_shapes(image=IMAGE, batch=SERVE_BATCH):
    """K8's launch shapes in one forward of wranet (feature_channels 128):
    rows of (B, H, W, C, O, launches): decoder_lv2 at image / 2, decoder_lv1
    at image."""
    return [(batch, image // 2, image // 2, WRANET_FC, WRANET_FC // 4, 1),
            (batch, image, image, WRANET_FC, WRANET_FC // 4, 1)]


def k8_work(b, h, w, c, o, k=9):
    """K8 (stride 1, padding 1): (tensor-core FLOPs, f32 operations, least
    bytes). The tap GEMMs are 2 K C O per pixel; the bilinear blend is 4
    multiply-adds per channel per (pixel, tap), about 30 operations more for
    the position and weights. Bytes: x, offset [2K] and mask [K] read once,
    the output written once (bf16), the bf16 weight and f32 bias once."""
    n = b * h * w
    return (2 * n * k * c * o, n * k * (8 * c + 30),
            2 * (n * c + n * 3 * k + n * o + k * c * o) + 4 * o)


def k8_issue_ms(b, h, w, c, k=9):
    """The exact blend's issue floor (stride 1, padding 1): K8 keeps g the
    plain version's bit for bit, so each channel of each (pixel, tap) takes
    4 multiplies and 3 adds rounded one by one (no FMA), 4 bf16 unpacking
    slots (two a corner pair of channels) and half a packing slot: 11.5
    lane-instructions, issued at most SM_LANES a clock on each SM at
    SM_CLOCK_HZ (the H100 SXM's 132 SMs, 4 schedulers of a warp each, at its
    1.98 GHz boost clock)."""
    return b * h * w * k * c * 11.5 / (H100_SMS * SM_LANES * SM_CLOCK_HZ) * 1e3


def k8_case(torch, gen, b, h, w, c, o, device, scale=3.0, k=3, stride=1, pad=1, dil=1):
    """bf16 K8 operands: offsets of std ``scale`` pixels (at 3 and above,
    samples past every edge of the frame), masks from a sigmoid, a k x k
    weight of O(1) outputs."""
    from unet_zoo_tpu_torch.ops.deform import out_size

    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    bf = torch.bfloat16
    ho, wo = out_size(h, w, k, k, stride, pad, dil)
    return (r(b, h, w, c).to(bf), (scale * r(b, ho, wo, 2 * k * k)).to(bf),
            torch.sigmoid(2.0 * r(b, ho, wo, k * k)).to(bf),
            (r(k, k, c, o) / (k * k * c) ** 0.5).to(bf), r(o).to(bf))


def k8_fault_positions(torch, clamp=True, column_major=False, swap_xy=False):
    """``ops/deform.py::sample_positions`` with one fault planted: positions
    not clamped to the 1-pixel frame, taps in column-major order, or the
    corner weights' x and y swapped."""
    from unet_zoo_tpu_torch.ops.deform import Samples

    def positions(h, w, offset, mask, kh, kw, stride=1, padding=1, dilation=1):
        b, ho, wo, _ = offset.shape
        k, dev = kh * kw, offset.device
        off = offset.float().reshape(b, ho, wo, k, 2)
        taps = torch.arange(k, device=dev)
        ky, kx = (taps % kh, taps // kh) if column_major else (taps // kw, taps % kw)
        by = (torch.arange(ho, device=dev) * stride - padding).float()
        bx = (torch.arange(wo, device=dev) * stride - padding).float()
        py = (by[:, None, None] + (ky * dilation).float()) + off[..., 0]
        px = (bx[None, :, None] + (kx * dilation).float()) + off[..., 1]
        if clamp:
            py, px = py.clamp(-1.0, float(h)), px.clamp(-1.0, float(w))
        py, px = py + 1.0, px + 1.0
        y0, x0 = torch.floor(py).clamp(0, h), torch.floor(px).clamp(0, w)
        wy1, wx1 = py - y0, px - x0
        if swap_xy:
            wy1, wx1 = wx1, wy1
        m = mask.float()
        cw = torch.stack([(1 - wy1) * (1 - wx1) * m, (1 - wy1) * wx1 * m,
                          wy1 * (1 - wx1) * m, wy1 * wx1 * m], dim=-1)
        idx = (y0.long() * (w + 2) + x0.long()).reshape(b, ho * wo, k)
        return Samples(idx, cw.reshape(b, ho * wo, k, 4))

    return positions


def k8_faults(torch, x, off, m, wt, bias, conv, on_pixels=False):
    """K8's plain version with one fault planted each: the mask ignored, the
    corner weights' x and y swapped, no clamp to the frame, taps in
    column-major order (each through ``k8_fault_positions`` in place of
    ``sample_positions`` for one call), and the kernel's own design fault
    (each tap's row tile times the next tap's weights, the source's
    test-only variant). With ``on_pixels`` (zero offsets: every sample on a
    pixel inside the frame, where x and y weigh 0 and the clamp never
    acts) the swap and the clamp are left out: they change nothing there."""
    from unet_zoo_tpu_torch.ops.kernels import deform as k8

    faults = {"mask ignored": k8.deform_conv2d_reference(x, off, torch.ones_like(m), wt, bias,
                                                         **conv),
              "next tap's weights (design)": k8.planted_fault(x, off, m, wt, bias, **conv)}
    real = k8.sample_positions
    for name, kw in (("corner weights x and y swapped", dict(swap_xy=True)),
                     ("no clamp to the frame", dict(clamp=False)),
                     ("taps in column-major order", dict(column_major=True))):
        if on_pixels and name != "taps in column-major order":
            continue
        k8.sample_positions = k8_fault_positions(torch, **kw)
        try:
            faults[name] = k8.deform_conv2d_reference(x, off, m, wt, bias, **conv)
        finally:
            k8.sample_positions = real
    return faults


# check_k8's cases: (B, H, W, C, O, k, stride, padding, dilation), each at
# offsets of std K8_OFFSET_STDS pixels
K8_CASES = [row[:5] + (3, 1, 1, 1) for row in wranet_launch_shapes()] + [
    (2, 37, 45, 40, 24, 3, 1, 1, 1),      # odd H, W; C 40, O 24
    (2, 19, 23, 20, 5, 3, 1, 1, 1),       # C not a multiple of 8, odd O
    (2, 20, 23, 64, 128, 3, 1, 1, 1),     # O 128
    (1, 19, 21, 24, 16, 7, 1, 3, 1),      # 7x7 kernel: K 49
    (2, 33, 31, 48, 32, 3, 2, 1, 1),      # stride 2
    (2, 29, 27, 32, 32, 3, 1, 2, 2),      # dilation 2
]
K8_OFFSET_STDS = (0.0, 1.0, 3.0, 8.0)


def check_k8(torch, gen, device):
    """K8 against its plain version (the same bf16 operands) at both wranet
    launch shapes (B=8, 256px), an odd shape, C not a multiple of 8, O 128, a
    7x7 kernel, stride 2 and dilation 2, each with offsets of std 0, 1, 3 and
    8 pixels (at 3 and 8 samples past every edge of the frame) and sigmoid
    masks; every case launches twice bit for bit and stands beside planted
    faults that the same comparison must reject. Returns the max abs error."""
    from unet_zoo_tpu_torch.ops.kernels import deform as k8

    err = 0.0
    for b, h, w, c, o, k, stride, pad, dil in K8_CASES:
        conv = dict(stride=stride, padding=pad, dilation=dil)
        for std in K8_OFFSET_STDS:
            args = k8_case(torch, gen, b, h, w, c, o, device, std, k, stride, pad, dil)
            got = k8.deform_conv2d(*args, **conv)
            again = k8.deform_conv2d(*args, **conv)
            ref = k8.deform_conv2d_reference(*args, **conv)
            caught = {name: ulp_reading(got, out)
                      for name, out in k8_faults(torch, *args, conv, std == 0).items()}
            torch.cuda.synchronize()
            assert got.shape == ref.shape and torch.isfinite(got.float()).all()
            if not torch.equal(got, again):
                raise AssertionError(f"K8 [{b}, {h}, {w}, {c}] -> {o}: two launches differ")
            reading = ulp_reading(got, ref)
            e = (got.float() - ref.float()).abs().max().item()
            ho, wo = args[1].shape[1:3]
            off = args[1].float().reshape(b, ho, wo, k * k, 2)
            taps = torch.arange(k * k, device=device)
            py = (torch.arange(ho, device=device)[:, None, None] * stride - pad
                  + (taps // k) * dil + off[..., 0])
            px = (torch.arange(wo, device=device)[None, :, None] * stride - pad
                  + (taps % k) * dil + off[..., 1])
            past = {edge: t.float().mean().item() for edge, t in (
                ("top", py < -1), ("bottom", py > h), ("left", px < -1), ("right", px > w))}
            log(f"K8 [{b}, {h}, {w}, {c}] -> {o}, k {k}, stride {stride}, dilation {dil}, "
                f"offsets std {std:g}: max_abs_err {e:.3e}; beyond one bf16 ulp {reading:.3e} "
                f"of the output rms (limit {K8_SHARE:.0e}); least of {len(caught)} planted "
                f"faults {min(caught.values()):.3e} ({min(caught, key=caught.get)}); samples "
                f"past the frame: {', '.join(f'{side} {v:.4f}' for side, v in past.items())}")
            if std >= 3 and not min(past.values()) > 0:
                raise AssertionError(f"K8's offsets do not reach past every edge: {past}")
            if not reading <= K8_SHARE:
                raise AssertionError(f"K8 disagrees with its plain version: {reading}")
            if not min(caught.values()) > K8_SHARE:
                raise AssertionError(f"the K8 comparison passed a planted fault: {caught}")
            err = max(err, e)
    return err


def draw_deform_offsets(torch, module):
    """The offset and modulator convs of every DeformableConv drawn off their
    zero init (std WRANET_OFFSET_SCALE and WRANET_MASK_SCALE over
    sqrt(fan_in), biases zero) from seed 13 (``models/wranet.py::
    draw_offsets``): at init the deformable conv is a plain conv times 0.5
    and never exercises the gather. Every model built from the same seed
    gets the same values (its own CPU generator)."""
    from unet_zoo_tpu_torch.models.wranet import draw_offsets

    draw_offsets(module, WRANET_OFFSET_SCALE, WRANET_MASK_SCALE, 13)


def deform_ranges(torch, x):
    """The offsets' and masks' ranges in each DeformableConv of the bf16
    wranet (seed 0, draw_deform_offsets) on ``x``, recomputed from each
    block's input; fails if the offsets stay below a pixel or the masks near
    0.5, where the deformable conv would not exercise the gather."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.models.wranet import DeformableConv
    from unet_zoo_tpu_torch.nn import conv

    model = create_model("wranet", dtype=torch.bfloat16, seed=0, feature_channels=WRANET_FC)
    draw_deform_offsets(torch, model.module)
    seen, hooks = [], []

    def record(name):
        def hook(mod, inputs, _):
            h = inputs[0]
            seen.append((name, "offset", conv(h, mod.offset_conv, mod.dtype).float()))
            seen.append((name, "mask", torch.sigmoid(conv(h, mod.modulator_conv, mod.dtype)
                                                      .float())))
        return hook

    for name, m in model.module.named_modules():
        if isinstance(m, DeformableConv):
            hooks.append(m.register_forward_hook(record(name)))
    with torch.inference_mode():
        model.module(x)
    for h in hooks:
        h.remove()
    out = {}
    for name, kind, t in seen:
        q = torch.quantile(t.flatten()[::97], torch.tensor([0.01, 0.5, 0.99], device=t.device))
        r = dict(min=t.min().item(), max=t.max().item(), std=t.std().item(), q01=q[0].item(),
                 median=q[1].item(), q99=q[2].item())
        out[f"{name} {kind}"] = r
        log(f"wranet {name} {kind}: range [{r['min']:.3f}, {r['max']:.3f}], std {r['std']:.3f}, "
            f"1%/50%/99% {r['q01']:.3f}/{r['median']:.3f}/{r['q99']:.3f}")
        if kind == "offset" and not (r["std"] > 0.25 and max(-r["min"], r["max"]) > 1.0):
            raise AssertionError(f"wranet {name}: offsets within a pixel, the gather idles: {r}")
        if kind == "mask" and not (r["q01"] < 0.4 and r["q99"] > 0.6):
            raise AssertionError(f"wranet {name}: masks do not spread over (0, 1): {r}")
    if len(out) != 2 * WRANET_LAUNCHES:
        raise AssertionError(f"wranet: offsets of {len(out) // 2} deformable convs seen")
    return out


def serve_wranet(torch, gen, device):
    """wranet (feature_channels 128), bf16, B=8, 256px, on both paths with the
    offset and modulator convs drawn alike off zero: K8 twice per forward by
    the counter and by the profiler, every K8 launch of the served forward
    against its plain version, agreement, rates and the device-time
    breakdown."""
    from unet_zoo_tpu_torch.ops.kernels import deform as k8

    preds, x, launches, agreement, _ = serve_both_paths(
        torch, gen, device, "wranet", SERVE_BATCH, IMAGE, [(k8, "deform_conv2d")], WRANET_REL_L2,
        WRANET_AGREE, WRANET_F32_RATIO, prepare=lambda m: draw_deform_offsets(torch, m),
        feature_channels=WRANET_FC)
    launches = launches["deform_conv2d"]
    if launches != WRANET_LAUNCHES:
        raise AssertionError(f"K8 ran {launches} times in wranet, expected {WRANET_LAUNCHES}")
    ranges = deform_ranges(torch, x)
    _, readings = checked_launches(torch, k8, "deform_conv2d", k8.deform_conv2d_reference,
                                   lambda: preds["kernel"](x))
    _, faults = checked_launches(torch, k8, "deform_conv2d",
                                 lambda *a: k8.planted_fault(*a), lambda: preds["kernel"](x))
    log(f"wranet: its {len(readings)} K8 launches against the plain version on the model's "
        f"own operands: {', '.join(f'{r:.3e}' for r in readings)} (<= {K8_SHARE:.0e}); "
        f"against the planted design fault (next tap's weights): "
        f"{', '.join(f'{r:.3e}' for r in faults)}")
    if len(readings) != WRANET_LAUNCHES or not max(readings) <= K8_SHARE:
        raise AssertionError("wranet: K8 disagrees with its plain version in the served model")
    if not min(faults) > K8_SHARE:
        raise AssertionError("wranet: the per-launch K8 check passed the planted design fault")
    events = profile_forward(torch, lambda: preds["kernel"](x))
    seen = sum("deform_kernel" in e.name for e in events)
    log(f"profiler: {seen} deform_kernel grids in one wranet forward")
    if seen != WRANET_LAUNCHES:
        raise AssertionError(f"profiler saw K8 {seen} times in wranet, expected "
                             f"{WRANET_LAUNCHES}")
    rates, med, busy = time_paths(torch, "wranet", preds, x, profile=True)
    return dict(launches=launches, profiler_grids=seen, launch_readings=readings,
                deform_ranges=ranges, serve_img_per_s=rates, forward_ms=med,
                device_busy_ms=busy, **agreement)


def time_k8(torch, gen, device):
    """K8 at each launch shape of one B=8 wranet forward (graph_ms): kernel,
    plain version, bound and the bf16 module chain it replaces
    (``ops/deform.py::deform_conv2d`` on the same operands; the model holds
    channels_last tensors, so neither path transposes). No PyTorch call
    computes a deformable conv (library_ms null)."""
    from unet_zoo_tpu_torch.ops import deform as module_deform
    from unet_zoo_tpu_torch.ops.kernels import deform as k8

    rows = []
    for b, h, w, c, o, n in wranet_launch_shapes():
        args = k8_case(torch, gen, b, h, w, c, o, device)
        with torch.inference_mode():
            ms = graph_ms(torch, lambda: k8.deform_conv2d(*args), 20)
            events = cuda_ms(torch, lambda: k8.deform_conv2d(*args), 20)
            plain_ms = graph_ms(torch, lambda: k8.deform_conv2d_reference(*args), 3)
            chain_ms = graph_ms(torch, lambda: module_deform.deform_conv2d(*args), 3)
        tc, f32, nbytes = k8_work(b, h, w, c, o)
        bound_ms, bound_by = bound(tc, nbytes, f32)
        issue_ms = k8_issue_ms(b, h, w, c)
        rows.append(dict(b=b, h=h, w=w, c=c, o=o, launches=n, tc_flops=tc, f32_ops=f32,
                         bytes=nbytes, ms=ms, events_ms=events, plain_ms=plain_ms,
                         module_chain_ms=chain_ms, bound_ms=bound_ms, bound_by=bound_by))
        log(f"K8 [{b}, {h}, {w}, {c}] -> {o} x{n}: {ms:.4f} ms by graph, {events:.4f} ms by "
            f"events, plain {plain_ms:.4f} ms, module chain {chain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {tc / ms / 1e9:.1f} TFLOP/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s), the exact blend's issue floor {issue_ms:.4f} ms")
    return rows


def int8_launch_shapes(name, image=IMAGE, batch=SERVE_BATCH):
    """The int8 conv's launch shapes in one forward of ``name`` as served here
    (unet 64 -> 1024 channels; unet_tpu at UNET_TPU_WIDTHS, the stem to
    image / 4): rows of (B, H, W, Ci, Co, stride, launches), H and W the
    conv's input, in the order of first launch."""
    from unet_zoo_tpu_torch.probes import int8_conv_plan

    return int8_conv_plan.launch_shapes(name, image, batch, UNET_TPU_WIDTHS)


def int8_conv_work(b, h, w, ci, co, stride, out_bytes, x_bytes=1):
    """P2's conv: (int8 operations, least bytes): 2 * 9 Ci multiply-adds per
    output element; x read once (``x_bytes`` an element: the float x the
    kernel quantises), the int8 weights, scale and bias once, the output
    written once. The quantisation's divisions are not counted."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    m = b * ho * wo
    return (2 * m * co * 9 * ci,
            x_bytes * b * h * w * ci + 9 * ci * co + 8 * co + out_bytes * m * co)


def int8_conv_case(torch, gen, b, h, w, ci, co, xdtype, device):
    """A float x of type ``xdtype`` (NHWC) with s_x = 2^-3, so that x / s_x
    is exact: a tenth of x on half-way points (n + 1/2) s_x, which round half
    to even, a twentieth at +-200 s_x, which clamp, the rest normal at 40 s_x;
    int8 OIHW weights over the whole range, a per-channel scale of calibrated
    size (s_x * s_w ~ 1e-4) and a bias."""
    s_x = torch.tensor(0.125, device=device)
    x = torch.randn(b, h, w, ci, generator=gen, device=device) * 40 * s_x
    spots = torch.rand(b, h, w, ci, generator=gen, device=device)
    half = (torch.randint(-127, 127, (b, h, w, ci), generator=gen, device=device) + 0.5) * s_x
    x = torch.where(spots < 0.1, half, x)
    x = torch.where(spots > 0.95, torch.sign(x) * 200 * s_x, x).to(xdtype)
    wq = torch.randint(-127, 128, (co, ci, 3, 3), generator=gen, device=device, dtype=torch.int8)
    scale = 1e-4 * (0.5 + torch.rand(co, generator=gen, device=device))
    return x, s_x, wq, scale, 0.1 * torch.randn(co, generator=gen, device=device)


def int8_timing_case(torch, gen, b, h, w, ci, co, xdtype, device):
    """int8_conv_case with the x a served conv sees: a ReLU output (half of
    it 0) of type ``xdtype``, s_x calibrated from its absmax; no value is
    planted on a half-way point."""
    from unet_zoo_tpu_torch.ops import quant

    _, _, wq, scale, bias = int8_conv_case(torch, gen, 1, 1, 1, ci, co, xdtype, device)
    x = torch.relu(torch.randn(b, h, w, ci, generator=gen, device=device)).to(xdtype)
    return x, quant.activation_scale(x.float().abs().amax()), wq, scale, bias


def int8_faults(torch, x, s_x, wq, scale, bias, stride, dtype):
    """P2's plain version with a fault planted each, on one image: the taps
    transposed, the stride ignored (each output read the input as at stride
    1), a per-tensor weight scale instead of the per-channel one, the bias
    dropped, x quantised with ties rounded away from zero."""
    from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2

    ref = lambda w_, sc, bi, st, x_=x, s_=s_x: p2.int8_conv3x3_reference(
        x_, s_, p2.pack_conv_weight(w_), sc, bi, st, dtype)
    t = x.float() / s_x
    ties_away = torch.clamp(torch.trunc(t + 0.5 * torch.sign(t)), -127, 127)
    faults = {"taps transposed": ref(wq.transpose(2, 3).contiguous(), scale, bias, stride),
              "per-tensor s_w": ref(wq, torch.full_like(scale, scale.max().item()), bias, stride),
              "bias dropped": ref(wq, scale, None, stride),
              "ties away from 0": ref(wq, scale, bias, stride, ties_away, torch.ones_like(s_x))}
    if stride == 2:
        ho, wo = (x.shape[1] - 1) // 2 + 1, (x.shape[2] - 1) // 2 + 1
        faults["stride ignored"] = ref(wq, scale, bias, 1)[:, :ho, :wo]
    return faults


def check_int8_conv(torch, gen, device):
    """P2's int8 conv against its plain version, bit for bit, at every
    distinct launch shape of the served unet_tpu (bf16 x and out), unet
    (float32), transatt_unet and unet_transformer (bf16) at B=8/256px and at
    odd shapes (Ci 3 and 20, odd H and W,
    stride 2 on an odd size, Co not a multiple of the tile), x drawn by
    int8_conv_case; the comparison is shown to reject planted faults
    (int8_faults) on the first image of each shape. Returns the max abs error
    (0 when every launch agrees bit for bit)."""
    from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2

    cases = [(*row[:6], torch.bfloat16) for row in int8_launch_shapes("unet_tpu")]
    cases += [(*row[:6], torch.float32) for row in int8_launch_shapes("unet")]
    # the shapes phase 24's int8 transatt_unet and unet_transformer add
    cases += sorted({(*row[:6], torch.bfloat16) for name in ("transatt_unet", "unet_transformer")
                     for row in int8_launch_shapes(name)} - set(cases), key=str)
    cases += [(2, 37, 45, 3, 24, 1, torch.bfloat16), (1, 33, 29, 20, 40, 2, torch.float32),
              (2, 31, 31, 48, 130, 2, torch.bfloat16)]
    err = 0.0
    for b, h, w, ci, co, stride, dtype in cases:
        x, s_x, wq, scale, bias = int8_conv_case(torch, gen, b, h, w, ci, co, dtype, device)
        wp = p2.pack_conv_weight(wq)
        got = p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype)
        ref = p2.int8_conv3x3_reference(x, s_x, wp, scale, bias, stride, dtype)
        faults = int8_faults(torch, x[:1], s_x, wq, scale, bias, stride, dtype)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dtype and torch.isfinite(got.float()).all()
        rms = ref.float().pow(2).mean().sqrt().item()
        e = (got.float() - ref.float()).abs().max().item()
        caught = {k: (got[:1].float() - f.float()).abs().max().item() / rms
                  for k, f in faults.items()}
        plan = p2.conv_plan(b * ((h - 1) // stride + 1) * ((w - 1) // stride + 1), co, wp.shape[1])
        log(f"P2 conv [{b}, {h}, {w}, {ci}] -> {co} stride {stride} {str(dtype)[6:]} (tile "
            f"{plan[0]} x {plan[1]}, K split {plan[2]}): max_abs_err {e:.3e} (bit for bit: "
            f"{torch.equal(got, ref)}); least planted fault "
            f"{min(caught.values()):.3e} of the output rms ({min(caught, key=caught.get)})")
        if not torch.equal(got, ref):
            raise AssertionError(f"the int8 conv kernel disagrees with its plain version: {e}")
        if not min(caught.values()) > 0:
            raise AssertionError(f"the int8 conv comparison passed a planted fault: {caught}")
        err = max(err, e)
    return err


def checked_int8_launches(torch, fn):
    """Run ``fn()`` with every int8 conv launch also held against the plain
    version on its own operands (bit for bit); returns (fn's result, launch
    shapes as int8_launch_shapes rows without counts, mismatching launches,
    launches whose x was not channels-last and was copied)."""
    from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2

    kernel, shapes, bad, copied = p2.int8_conv3x3, [], [], []

    def launch(x, s_x, wp, scale, bias, stride, dtype):
        got = kernel(x, s_x, wp, scale, bias, stride, dtype)
        shapes.append((*x.shape, wp.shape[0], stride))
        if not x.is_contiguous():
            copied.append(shapes[-1])
        ref = p2.int8_conv3x3_reference(x, s_x, wp, scale, bias, stride, dtype)
        if not torch.equal(got, ref):
            bad.append(shapes[-1])
        return got

    p2.int8_conv3x3 = launch
    try:
        return fn(), shapes, bad, copied
    finally:
        p2.int8_conv3x3 = kernel


def serve_int8(torch, gen, device, name):
    """``name`` calibrated on two seeded batches and served three ways at
    B=8/256px: float, int8 on the kernel path, int8 on the plain path (unet
    also in bf16 float, its K1 path). The int8 conv must run
    INT8_LAUNCHES[name] times per forward by counter and by profiler, and K1
    never; every launch of a served forward is held against the plain version
    on its own operands; the paths' logits and masks are compared, and int8
    against float; img/s (the plain int8 path, f64 on the card, timed over
    one forward) and device-time breakdowns."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
    from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2
    from unet_zoo_tpu_torch.utils.serving import calibrate_int8, make_predictor

    tpu = name in INT8_BF16
    dtype, want = (torch.bfloat16 if tpu else torch.float32), INT8_LAUNCHES[name]
    float_rel_l2, float_agree = INT8_FLOAT_BARS.get(name, (INT8_FLOAT_REL_L2, INT8_FLOAT_AGREE))
    kern = member_model(torch, name, dtype)
    plain = member_model(torch, name, dtype, use_kernels=False)
    log(f"{name} ({str(dtype)[6:]}): {sum(p.numel() for p in kern.module.parameters()) / 1e6:.2f}"
        " M parameters")
    batches = [torch.randn(SERVE_BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
               for _ in range(2)]
    stats = calibrate_int8(kern, batches)
    if len(stats) != want:
        raise AssertionError(f"{name}: {len(stats)} calibrated convs, expected {want}")
    x = torch.randn(SERVE_BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
    preds = {"float": make_predictor(kern, None, "logits", cast_bf16=tpu),
             "int8 kernel": make_predictor(kern, None, "logits", cast_bf16=tpu, quant=stats),
             "int8 plain": make_predictor(plain, None, "logits", cast_bf16=tpu, quant=stats)}
    if not tpu:
        preds["bf16 float"] = make_predictor(create_model(name, dtype=torch.bfloat16, seed=0),
                                             None, "logits")

    p2.LAUNCHES["int8_conv3x3"], k1.LAUNCHES["fused_up_concat_conv"] = 0, 0
    lk = preds["int8 kernel"](x)
    torch.cuda.synchronize()
    launches, k1_launches = p2.LAUNCHES["int8_conv3x3"], k1.LAUNCHES["fused_up_concat_conv"]
    log(f"main path: int8 conv {launches} launches, K1 {k1_launches} in one int8 {name} forward")
    if launches != want or k1_launches:
        raise AssertionError(f"{name}: int8 conv ran {launches} times (K1 {k1_launches}), "
                             f"expected {want} (K1 0)")
    lp, lf = preds["int8 plain"](x), preds["float"](x)
    torch.cuda.synchronize()
    for t in (lk, lp, lf):
        assert t.shape == (SERVE_BATCH, 1, IMAGE, IMAGE) and torch.isfinite(t).all()
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    agree = lambda a, b: ((a > 0) == (b > 0)).float().mean().item()
    readings = dict(paths_rel_l2=rel(lk, lp), paths_mask_agreement=agree(lk, lp),
                    paths_bit_for_bit=torch.equal(lk, lp), int8_vs_float_rel_l2=rel(lk, lf),
                    int8_vs_float_mask_agreement=agree(lk, lf))
    log(f"serve {name} int8: logits std {lf.std().item():.4f}; kernel vs plain path rel L2 "
        f"{readings['paths_rel_l2']:.3e} (<= {INT8_PATHS_REL_L2:.0e}), masks "
        f"{readings['paths_mask_agreement']:.5f} (>= {INT8_PATHS_AGREE}), bit for bit "
        f"{readings['paths_bit_for_bit']}; int8 vs float rel L2 "
        f"{readings['int8_vs_float_rel_l2']:.3e} (< {float_rel_l2}), masks "
        f"{readings['int8_vs_float_mask_agreement']:.5f} (>= {float_agree})")
    if not (readings["paths_rel_l2"] <= INT8_PATHS_REL_L2
            and readings["paths_mask_agreement"] >= INT8_PATHS_AGREE):
        raise AssertionError(f"{name}: the int8 kernel path disagrees with the plain path")
    if not (readings["int8_vs_float_rel_l2"] < float_rel_l2
            and readings["int8_vs_float_mask_agreement"] >= float_agree):
        raise AssertionError(f"{name}: int8 serving strays from float beyond JAX's bars")

    _, shapes, bad, copied = checked_int8_launches(torch, lambda: preds["int8 kernel"](x))
    expected = sorted(r[:6] for r in int8_launch_shapes(name) for _ in range(r[6]))
    log(f"{name}: its {len(shapes)} int8 conv launches against the plain version on their own "
        f"operands: {len(shapes) - len(bad)} bit for bit; x copied to channels-last for "
        f"{len(copied)}: {copied}")
    if bad or len(shapes) != want or sorted(shapes) != expected:
        raise AssertionError(f"{name}: int8 launches {shapes}, mismatching {bad}")
    events = profile_forward(torch, lambda: preds["int8 kernel"](x))
    seen = sum("p2_kernel" in e.name for e in events)
    for _ in range(PROFILE_TRIES - 1):
        if seen == want:
            break
        # two traces in a row can lose the same record (seen once on unet)
        log(f"profiler: {seen} P2 conv grids against {want} launches; tracing again")
        PROFILE_RETAKES[0] += 1
        events = profile_forward(torch, lambda: preds["int8 kernel"](x))
        seen = sum("p2_kernel" in e.name for e in events)
    seen_k1 = sum("fused_up_" in e.name for e in events)
    log(f"profiler: {seen} P2 conv grids, {seen_k1} K1 grids in one int8 {name} forward")
    if seen != want or seen_k1:
        grids = {}
        for e in events:
            grids[e.name[:60]] = grids.get(e.name[:60], 0) + 1
        raise AssertionError(f"profiler saw the int8 conv {seen} times (K1 {seen_k1}) in {name}: "
                             f"{grids}")
    # x is quantised inside P2's conv: no ATen round, and no divide or clamp
    # pass beyond what the float path launches
    quant_passes = {}
    for path, evs in (("int8 kernel", events),
                      ("float", profile_forward(torch, lambda: preds["float"](x)))):
        quant_passes[path] = {op: sum(op in e.name.lower() for e in evs)
                              for op in ("round", "div", "clamp")}
    log(f"profiler: round/div/clamp kernels per forward {quant_passes}")
    qi, qf = quant_passes["int8 kernel"], quant_passes["float"]
    if qi["round"] or qi["div"] > qf["div"] or qi["clamp"] > qf["clamp"]:
        raise AssertionError(f"{name}: the int8 path still quantises x outside the kernel: "
                             f"{quant_passes}")

    timed = {k: v for k, v in preds.items() if k != "int8 plain"}
    times = serve_times(torch, timed, x)
    med = {k: statistics.median(v) for k, v in times.items()}
    med["int8 plain"] = cuda_ms(torch, lambda: preds["int8 plain"](x), 1)
    rates = {k: SERVE_BATCH / (m / 1e3) for k, m in med.items()}
    for path in med:
        log(f"serve {name} B={SERVE_BATCH} {IMAGE}px, {path}: {rates[path]:.1f} img/s "
            f"(forward {med[path]:.4f} ms)")
    busy = {path: breakdown(torch, f"{name} {path}", lambda: preds[path](x), med[path])
            for path in ("float", "int8 kernel")}
    return dict(launches=launches, k1_launches=k1_launches, profiler_grids=seen,
                launches_bit_for_bit=len(shapes) - len(bad), x_copied=copied,
                quant_passes=quant_passes, serve_img_per_s=rates,
                forward_ms=med, device_busy_ms=busy,
                idle_share={p: 1 - busy[p] / med[p] for p in busy}, **readings)


def time_int8_conv(torch, gen, device, name):
    """P2's conv at each launch shape of one B=8 forward of ``name``, from the
    float x it quantises (bf16 for unet_tpu, float32 for unet; drawn by
    int8_timing_case, as a served conv sees it): kernel and cuDNN by CUDA
    graph replay (``graph_ms``: a launch's host cost, 20-70 us through the
    wrapper, exceeds the small shapes' device time), plain
    version (float64 on the card), bound (int8 operations), and cuDNN's bf16
    conv of the same shape (a yardstick of what int8 saves; no PyTorch call
    computes the int8 conv, so library_ms is null); the plan (tile, splits)
    and the host's cost of one launch through the wrapper (the mean of 200
    back-to-back calls, queued behind a spin of the device so that none
    waits on it)."""
    import torch.nn.functional as F

    from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2

    dtype = torch.bfloat16 if name in INT8_BF16 else torch.float32
    rows = []
    for b, h, w, ci, co, stride, n in int8_launch_shapes(name):
        x, s_x, wq, scale, bias = int8_timing_case(torch, gen, b, h, w, ci, co, dtype, device)
        wp = p2.pack_conv_weight(wq)
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = wq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        ms = graph_ms(torch, lambda: p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype), 20)
        plain_ms = cuda_ms(torch, lambda: p2.int8_conv3x3_reference(x, s_x, wp, scale, bias,
                                                                     stride, dtype), 2)
        cudnn_ms = graph_ms(torch, lambda: F.conv2d(xb, wb, bb, stride=stride, padding=1), 20)
        ops, nbytes = int8_conv_work(b, h, w, ci, co, stride, 2 if dtype == torch.bfloat16 else 4,
                                     x.element_size())
        bound_ms, bound_by = bound(0, nbytes, int8_ops=ops)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        plan = p2.conv_plan(b * ho * wo, co, wp.shape[1])
        rows.append(dict(model=name, b=b, h=h, w=w, ci=ci, co=co, stride=stride, launches=n,
                         tile=plan[:2], splits=plan[2], int8_ops=ops, bytes=nbytes, ms=ms,
                         plain_ms=plain_ms, cudnn_bf16_ms=cudnn_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        log(f"P2 conv {name} [{b}, {h}, {w}, {ci}] -> {co} s{stride} x{n} (tile {plan[0]} x "
            f"{plan[1]}, K split {plan[2]}): {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s, "
            f"{bound_ms / ms:.3f} of its bound {bound_ms:.4f} ms, {bound_by}), plain "
            f"{plain_ms:.4f} ms, cuDNN bf16 conv {cudnn_ms:.4f} ms")
    b, h, w, ci, co, stride, _ = int8_launch_shapes(name)[-1]
    x, s_x, wq, scale, bias = int8_timing_case(torch, gen, b, h, w, ci, co, dtype, device)
    wp = p2.pack_conv_weight(wq)
    p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    t0 = time.perf_counter()
    for _ in range(200):
        p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"P2 conv {name}: {host_us:.1f} us of host time a launch through the wrapper")
    return rows, host_us


def check_gemm(torch, gen, device):
    """P2's GEMM at M = N = K = GEMM_SIZE: s8 bit for bit against
    ``torch._int_mm``, bf16 against the float32 product (1e-5 sqrt(K) of the
    output rms), each beside a planted fault (B read as [K, N]), and both
    at ragged shapes; then the probe's own path (``probes.int8_matmul``, 20
    timed launches of each type) with the launch counter set to 0 just
    before it; kernel (at GEMM_TILE and at every tile), plain version,
    library call and bound of each type."""
    from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2
    from unet_zoo_tpu_torch.probes import int8_matmul as probe

    n = GEMM_SIZE
    a8, b8 = probe.operands(n, n, n, torch.int8, 7, device)
    a16, b16 = probe.operands(n, n, n, torch.bfloat16, 8, device)
    got8, lib8 = p2.matmul(a8, b8, GEMM_TILE), torch._int_mm(a8, b8.t())
    got16, ref16 = p2.matmul(a16, b16, GEMM_TILE), p2.matmul_reference(a16, b16)
    torch.cuda.synchronize()
    exact = torch.equal(got8, lib8)
    err16 = (got16 - ref16).abs().max().item()
    lim16 = 1e-5 * n ** 0.5 * ref16.pow(2).mean().sqrt().item()
    fault8 = not torch.equal(got8, torch._int_mm(a8, b8))
    fault16 = (got16 - p2.matmul_reference(a16, b16.t().contiguous())).abs().max().item()
    log(f"P2 GEMM {n}^3: s8 bit for bit against torch._int_mm: {exact} (fault B as [K, N] "
        f"caught: {fault8}); bf16 max_abs_err {err16:.3e} (limit {lim16:.3e}; fault "
        f"{fault16:.3e})")
    if not (exact and fault8 and err16 <= lim16 < fault16):
        raise AssertionError("the GEMM kernel disagrees with its plain version or library call")
    for m, nn, k in ((300, 200, 64), (300, 200, 128), (131, 1000, 4096)):
        for tile in p2.GEMM_TILES:
            a, b = probe.operands(m, nn, k, torch.int8, m + k, device)
            if not torch.equal(p2.matmul(a, b, tile), torch._int_mm(a, b.t())):
                raise AssertionError(f"the s8 GEMM kernel disagrees at {m, nn, k}, tile {tile}")
            a, b = probe.operands(m, nn, k, torch.bfloat16, m + k, device)
            ref = p2.matmul_reference(a, b)
            e = (p2.matmul(a, b, tile) - ref).abs().max().item()
            if not e <= 1e-5 * k ** 0.5 * ref.pow(2).mean().sqrt().item():
                raise AssertionError(f"the bf16 GEMM kernel disagrees at {m, nn, k}: {e}")
    log(f"P2 GEMM: s8 bit for bit and bf16 within its limit at [300, 200] K 64 and 128, "
        f"[131, 1000] K 4096, tiles {p2.GEMM_TILES}")

    p2.LAUNCHES["matmul"] = 0
    probe_s = {"bf16": probe.bench_case("hopper bf16xbf16->f32", n, n, n, torch.bfloat16, 20,
                                        GEMM_TILE, device),
               "s8": probe.bench_case("hopper s8xs8->s32   ", n, n, n, torch.int8, 20,
                                      GEMM_TILE, device)}
    launches = p2.LAUNCHES["matmul"]
    out = dict(launches=launches, s8_bit_for_bit=exact, bf16_max_abs_err=err16)
    for key, a, b, lib in (("s8", a8, b8, lambda: torch._int_mm(a8, b8.t())),
                           ("bf16", a16, b16, lambda: torch.matmul(a16, b16.t()))):
        ms = cuda_ms(torch, lambda: p2.matmul(a, b, GEMM_TILE), 20)
        plain_ms = cuda_ms(torch, lambda: p2.matmul_reference(a, b), 3)
        lib_ms = cuda_ms(torch, lib, 20)
        ops = 2 * n ** 3
        nbytes = 2 * n * n * a.element_size() + 4 * n * n
        bound_ms, bound_by = bound(ops if key == "bf16" else 0, nbytes,
                                   int8_ops=ops if key == "s8" else 0)
        tile_ms = {f"{bm}x{bn}": cuda_ms(torch, lambda: p2.matmul(a, b, (bm, bn)), 20)
                   for bm, bn in p2.GEMM_TILES}
        out[key] = dict(ms=ms, probe_ms=1e3 * probe_s[key] / 20, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                        tera_per_s=ops / ms / 1e9, library_tera_per_s=ops / lib_ms / 1e9,
                        tile_ms=tile_ms)
        log(f"P2 GEMM {key} {n}^3: {ms:.4f} ms ({ops / ms / 1e9:.1f} T/s, {bound_ms / ms:.3f} of "
            f"its bound {bound_ms:.4f} ms), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
            f"({ops / lib_ms / 1e9:.1f} T/s); by tile {tile_ms}")
    out["int8_over_bf16"] = out["bf16"]["ms"] / out["s8"]["ms"]
    out["library_int8_over_bf16"] = out["bf16"]["library_ms"] / out["s8"]["library_ms"]
    log(f"P2 GEMM: int8 / bf16 rate {out['int8_over_bf16']:.3f}x (library "
        f"{out['library_int8_over_bf16']:.3f}x); {launches} launches on the probe's path")
    return out


def check_gather(torch, gen, device):
    """P1 at the probe's shape: the probe's own path (``probes.gather``,
    kernel variant) with the launch counter set to 0 just before it, bit for
    bit against index_select on fresh indices beside a planted fault (each
    index one row off), and timed by CUDA graph replay against the bytes
    bound and index_select (the plain version and the library call)."""
    from unet_zoo_tpu_torch.ops.kernels import row_gather as p1
    from unet_zoo_tpu_torch.probes import gather as probe

    p1.LAUNCHES["row_gather"] = 0
    probed = probe.run("kernel", GATHER_N, device)
    launches = p1.LAUNCHES["row_gather"]
    tab = torch.randn(GATHER_ROWS, GATHER_C, generator=gen, device=device)
    idx = torch.randint(0, GATHER_ROWS, (GATHER_N,), generator=gen, device=device,
                        dtype=torch.int32)
    got, ref = p1.row_gather(tab, idx), p1.row_gather_reference(tab, idx)
    fault = p1.row_gather_reference(tab, (idx + 1) % GATHER_ROWS)
    torch.cuda.synchronize()
    exact = torch.equal(got, ref) and probed["max_abs_err"] == 0
    log(f"P1 gather [{GATHER_ROWS}, {GATHER_C}] x {GATHER_N}: bit for bit {exact}, planted fault "
        f"caught {not torch.equal(got, fault)}; {launches} launches on the probe's path")
    if not exact or torch.equal(got, fault):
        raise AssertionError("the row gather kernel disagrees with index_select")
    ms = graph_ms(torch, lambda: p1.row_gather(tab, idx), 20)
    plain_ms = graph_ms(torch, lambda: p1.row_gather_reference(tab, idx), 20)
    nbytes = 2 * GATHER_N * GATHER_C * 4 + 4 * GATHER_N
    bound_ms, bound_by = bound(0, nbytes)
    log(f"P1 gather: {ms:.5f} ms ({nbytes / ms / 1e6:.1f} GB/s, {bound_ms / ms:.3f} of its bound "
        f"{bound_ms:.5f} ms), index_select {plain_ms:.5f} ms")
    return dict(launches=launches, max_abs_err=(got - ref).abs().max().item(), ms=ms,
                plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, probe=probed)


def check_k1(torch, gen, device):
    """K1 against its plain version at the served stage shapes (B=8) and
    K1_EDGE_CASES: each grid's error beyond one bf16 ulp over its output's
    rms against its half of the plain version (limit K1_SHARE), the
    parent's max-abs bar for the whole against the plain version in f32,
    two launches bit for bit (up and output), each planted fault's output
    rejected by the conv's reading, and the plan's ring against the
    source's. Returns the max abs error."""
    from unet_zoo_tpu_torch.ops.kernels import fused_up as k1

    for tile in k1.SOURCE_TILES:
        if k1.source_geometry(*tile) != k1.ring(*tile) or k1.ring(*tile)[0] < 2:
            raise AssertionError(f"K1's source ring {k1.source_geometry(*tile)} is not the "
                                 f"plan's {k1.ring(*tile)} (mode, bn, blocks an SM {tile})")
    cases = [(SERVE_BATCH, cin, cu, cu, cu, hc, hc) for cin, cu, hc in STAGES] + K1_EDGE_CASES
    err = 0.0
    for b, cin, cu, cs, co, hc, wc in cases:
        args = stage_case(torch, gen, b, cin, cu, cs, co, hc, wc, device)
        y, skip, wt, bt, wc_, sc, bi = args
        packed = k1.pack_kernel_weights(wt, wc_)
        up, got = k1.kernel_stages(*args, packed)
        up2, again = k1.kernel_stages(*args, packed)
        up_ref = k1.convt_reference(y, wt, bt)
        ref = k1.conv_reference(up, skip, wc_, sc, bi)
        ref32 = k1.fused_up_concat_conv_reference(*[a.float() for a in args])
        caught = {name: ulp_reading(k1.kernel_stages(*args, packed, name)[1], ref)
                  for name in k1.FAULTS}
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        if not (torch.equal(got, again) and torch.equal(up, up2)):
            raise AssertionError(f"K1 y={[b, cin, hc, wc]}: two launches differ")
        reading = max(ulp_reading(up, up_ref), ulp_reading(got, ref))
        e = (got.float() - ref32).abs().max().item()
        tol = 1e-2 * (1 + ref32.abs().max().item())
        p = k1.plan(b, hc, wc, cin, cu, cs, co)
        log(f"K1 y={[b, cin, hc, wc]} skip={[b, cs, 2 * hc, 2 * wc]} Co={co} (tile {p.bh}x{k1.BW}"
            f"x{p.bn}): beyond one bf16 ulp {reading:.3e} of the output rms (limit "
            f"{K1_SHARE:.0e}); max_abs_err {e:.3e} against f32 (bound {tol:.3e}); least of "
            f"{len(caught)} planted faults {min(caught.values()):.3e} "
            f"({min(caught, key=caught.get)})")
        if not (reading <= K1_SHARE and e <= tol):
            raise AssertionError(f"K1 disagrees with its plain version: {reading}, {e} > {tol}")
        if not min(caught.values()) > K1_SHARE:
            raise AssertionError(f"the K1 comparison passed a planted fault: {caught}")
        err = max(err, e)
    return err


class ArrayDataset:
    """In-memory items in the BoneDataset layout: uint8 HWC images, {0, 1}
    uint8 HW1 masks."""

    def __init__(self, images, masks):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.masks[i], f"smoke://{i}"


def blob_data(seed, n, size):
    """n uint8 images of noise brightened inside a circular blob, and the
    blobs as masks, made in bulk from ``seed`` (SyntheticDataset's recipe
    in uint8)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cy, cx = rng.integers(size // 4, 3 * size // 4, size=(2, n, 1, 1))
    r = rng.integers(size // 8, size // 4, size=(n, 1, 1))
    yy, xx = np.mgrid[:size, :size]
    masks = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8)
    noise = rng.standard_normal((n, size, size, 3), dtype=np.float32)
    images = np.clip(96 + 32 * noise + 64 * masks[..., None], 0, 255).astype(np.uint8)
    return images, masks[..., None]


def loop_config(root, epochs):
    """The loop's config: LOOP_TRAINING for ``epochs``, flips on the device."""
    from unet_zoo_tpu_torch.config import Config

    return Config({"general": {"project_name": "chip_smoke", "working_dir": root},
                   "data": {"dataset_dir": "in memory", "num_workers": 0, "image_size": IMAGE,
                            "augment": True, "augment_on_device": True},
                   "training": dict(LOOP_TRAINING, epochs=epochs),
                   "tpu": {"compute_dtype": "bfloat16"}, "run_timestamp": "smoke"})


def same_tree(torch, a, b, where):
    """Raise unless two nested containers of tensors and plain values are
    equal, every tensor bit for bit (compared on the host)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())):
            raise AssertionError(f"resume: {where} differs from what was saved")
    elif isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            raise AssertionError(f"resume: {where} keys differ: {sorted(set(a) ^ set(b))}")
        for k in a:
            same_tree(torch, a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"resume: {where} lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(torch, x, y, f"{where}[{i}]")
    elif a != b:
        raise AssertionError(f"resume: {where} is {a!r}, saved {b!r}")


def train_loop(torch, device):
    """Phase 21: full-width bf16 unet through train_model (2 epochs, then a
    resume for a third) and evaluate_model on the best checkpoint; gated
    through train_model for one epoch. Returns the readings."""
    import os
    import re
    import shutil
    import tempfile

    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.data import create_loader
    from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6
    from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
    from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
    from unet_zoo_tpu_torch.train import create_train_state, make_eval_step
    from unet_zoo_tpu_torch.train.early_stopping import EarlyStopping
    from unet_zoo_tpu_torch.train.loop import (evaluate_model, restore_checkpoint, train_model,
                                               validate_one_epoch)
    from unet_zoo_tpu_torch.train.lr_scheduler import DiceScheduler
    from unet_zoo_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint
    from unet_zoo_tpu_torch.utils.logger import Logger

    t0 = time.perf_counter()
    images, masks = blob_data(zlib.crc32(b"train_loop"), LOOP_TRAIN + LOOP_VALID, IMAGE)
    train_set = ArrayDataset(images[:LOOP_TRAIN], masks[:LOOP_TRAIN])
    valid_set = ArrayDataset(images[LOOP_TRAIN:], masks[LOOP_TRAIN:])
    loader = lambda ds, shuffle: create_loader(ds, SERVE_BATCH, shuffle=shuffle, drop_last=shuffle,
                                               num_workers=0, pin_memory=True)
    train_loader, val_loader = loader(train_set, True), loader(valid_set, False)
    val_batches = len(val_loader)
    bf16 = torch.bfloat16
    plain = create_model("unet", dtype=bf16, seed=0, use_kernels=False)
    plain_eval = make_eval_step(plain)
    epochs = []

    class EpochLog(Logger):
        """The loop's logger; at each epoch block (after that epoch's
        validation, with the weights it validated) it reads the block and
        runs the same validation on the plain module path."""

        def __init__(self, model):
            super().__init__(None)
            self.model, self.mark = model, time.perf_counter()

        def log_both(self, message):
            super().log_both(message)
            if " - Epoch " not in message:
                return
            t_epoch = time.perf_counter() - self.mark
            n = k1.LAUNCHES["fused_up_concat_conv"]
            plain.module.load_state_dict(self.model.module.state_dict())
            loss, dice = validate_one_epoch(plain_eval, None, val_loader, "unet plain", self, device)
            if k1.LAUNCHES["fused_up_concat_conv"] != n:
                raise AssertionError("the plain module path launched K1")
            read = lambda key: float(re.search(key + r":\s+([-\d.e+]+)", message).group(1))
            epochs.append(dict(epoch=int(re.search(r"Epoch (\d+)/", message).group(1)),
                               train_loss=read("Train Loss"), val_loss=read("Val Loss"),
                               val_dice=read("Val DICE"), lr=read("Learning Rate"),
                               train_img_per_s=read("Train throughput"), epoch_s=t_epoch,
                               plain_val_loss=loss, plain_val_dice=dice))
            self.mark = time.perf_counter()

    root = tempfile.mkdtemp(prefix="_scratch_loop_", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        best, last = os.path.join(root, "unet_best"), os.path.join(root, "unet_last")
        kern = create_model("unet", dtype=bf16, seed=0)
        state = create_train_state(kern, LOOP_TRAINING["learning_rate"])
        runs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for n_epochs, resume in ((2, False), (3, True)):
            if resume:
                # the live state at the end of the first run, as saved
                saved = load_checkpoint(last)
                same_tree(torch, dict(kern.module.state_dict()), saved["variables"], "state_dict")
                same_tree(torch, state.optimizer.adamw.state_dict(), saved["opt_state"], "AdamW")
                if saved["step"] != state.step or saved["meta"]["epoch"] != 2:
                    raise AssertionError(f"resume: saved step {saved['step']}, epoch "
                                         f"{saved['meta']['epoch']}; trained {state.step}, 2")
                # a model of other weights, restored from the last checkpoint
                kern = create_model("unet", dtype=bf16, seed=1)
                state = create_train_state(kern, LOOP_TRAINING["learning_rate"])
                sched = DiceScheduler(lr=1.0, verbose=False)
                stop = EarlyStopping(verbose=False)
                if restore_checkpoint(last, state, sched, stop) != 2:
                    raise AssertionError("resume: the last checkpoint is not epoch 2's")
                same_tree(torch, dict(kern.module.state_dict()), saved["variables"], "state_dict")
                same_tree(torch, state.optimizer.adamw.state_dict(), saved["opt_state"], "AdamW")
                same_tree(torch, [state.step, state.optimizer.lr, sched.state_dict(),
                                  stop.state_dict()],
                          [saved["step"], saved["scheduler"]["lr"], saved["scheduler"],
                           saved["early_stopping"]], "step, lr, scheduler, early stopping")
                log(f"resume: state_dict, AdamW state, step {state.step}, lr {state.optimizer.lr}, "
                    f"scheduler and early stopping restored bit for bit as saved")
            k1.LAUNCHES["fused_up_concat_conv"] = 0
            logger = EpochLog(kern)
            out = train_model(kern, train_loader, val_loader, loop_config(root, n_epochs), "unet",
                              best, last, logger, state=state, resume=resume)
            torch.cuda.synchronize()
            runs.append(dict(epochs=len(out[0]), launches=k1.LAUNCHES["fused_up_concat_conv"],
                             train_loss=out[0], val_loss=out[2], val_dice=out[3]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        returned = zip(*(sum((r[key] for r in runs), []) for key in
                         ("train_loss", "val_loss", "val_dice")))
        for e, (train_loss, val_loss, val_dice) in zip(epochs, returned):
            e.update(train_loss=train_loss, val_loss=val_loss, val_dice=val_dice)
        k1_launches = sum(r["launches"] for r in runs)
        n_epochs = sum(r["epochs"] for r in runs)
        log(f"main path: K1 launches {k1_launches} in {n_epochs} epochs of the unet loop "
            f"({val_batches} validation batches an epoch)")
        if [r["epochs"] for r in runs] != [2, 1] or len(epochs) != 3:
            raise AssertionError(f"the loop ran {[r['epochs'] for r in runs]} epochs, expected 2 and 1")
        for r in runs:
            if r["launches"] != len(STAGES) * val_batches * r["epochs"]:
                raise AssertionError(f"K1 ran {r['launches']} times in {r['epochs']} epochs, "
                                     f"expected {len(STAGES)} a validation batch")
        for e in epochs:
            rel = abs(e["val_loss"] - e["plain_val_loss"]) / abs(e["plain_val_loss"])
            dd = abs(e["val_dice"] - e["plain_val_dice"])
            log(f"loop unet epoch {e['epoch']}: train {e['train_img_per_s']:.1f} img/s (loader + "
                f"step), epoch {e['epoch_s']:.2f} s, train loss {e['train_loss']:.6f}, val loss "
                f"{e['val_loss']:.6f} through K1 / {e['plain_val_loss']:.6f} plain (rel "
                f"{rel:.2e} <= {LOOP_VAL_REL:.0e}), Dice {e['val_dice']:.6f} / "
                f"{e['plain_val_dice']:.6f} (diff {dd:.2e} <= {LOOP_DICE_ABS:.0e}), lr {e['lr']:.2e}")
            if not (rel <= LOOP_VAL_REL and dd <= LOOP_DICE_ABS):
                raise AssertionError(f"epoch {e['epoch']}: validation through K1 disagrees with "
                                     "the plain module path")
        if not epochs[2]["train_loss"] < epochs[0]["train_loss"]:
            raise AssertionError("the train loss of epoch 3 is not below that of epoch 1")
        if not (checkpoint_exists(best) and checkpoint_exists(last)):
            raise AssertionError("the best or last checkpoint is missing")

        # validation rate through K1 (the trained model), then its grids by profiler
        eval_step = make_eval_step(kern)
        validate_one_epoch(eval_step, None, val_loader, "unet", logger, device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        validate_one_epoch(eval_step, None, val_loader, "unet", logger, device)
        torch.cuda.synchronize()
        val_rate = LOOP_VALID / (time.perf_counter() - t)
        grids = {g: sum(g in e.name for e in profile_forward(
            torch, lambda: validate_one_epoch(eval_step, None, val_loader, "unet", logger, device)))
            for g in ("fused_up_convt_kernel", "fused_up_conv3x3_kernel")}
        log(f"profiler: {grids} K1 grids in one validation pass of {val_batches} batches; "
            f"validation {val_rate:.1f} img/s; peak memory {peak:.2f} GiB")
        if grids != dict.fromkeys(grids, len(STAGES) * val_batches):
            raise AssertionError(f"profiler saw K1 grids {grids}, expected "
                                 f"{len(STAGES) * val_batches} each")

        restored = load_checkpoint(best)
        test_loss, test_dice = evaluate_model(kern, restored["variables"], val_loader, "unet", logger)
        if not (test_loss == test_loss and abs(test_loss) < float("inf") and 0 <= test_dice <= 1):
            raise AssertionError(f"evaluate_model on the best checkpoint: {test_loss}, {test_dice}")
        log(f"evaluate_model on the best checkpoint (epoch {restored['meta']['epoch']}): loss "
            f"{test_loss:.6f}, Dice {test_dice:.6f}")
        unet = dict(epochs=epochs, k1_launches=k1_launches, val_batches=val_batches,
                    val_img_per_s=val_rate, peak_gib=peak, profiler_grids=grids,
                    best_epoch=restored["meta"]["epoch"], test_loss=test_loss, test_dice=test_dice)
        del kern, plain, state
        torch.cuda.empty_cache()

        # gated through the same loop: K7 in every step, K6 in every validation batch
        steps = LOOP_GATED_STEPS
        g_loader = loader(ArrayDataset(images[:steps * SERVE_BATCH], masks[:steps * SERVE_BATCH]), True)
        gated = create_model("gated", dtype=bf16, seed=0, image_size=IMAGE)
        for key in K7_GRIDS:
            k7.LAUNCHES[key] = 0
        k6.LAUNCHES["fused_axial_attention"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = train_model(gated, g_loader, val_loader, loop_config(root, 1), "gated",
                          os.path.join(root, "gated_best"), os.path.join(root, "gated_last"),
                          Logger(None))
        torch.cuda.synchronize()
        g_seconds = time.perf_counter() - t
        k7_loop = {key: k7.LAUNCHES[key] for key in K7_GRIDS}
        k6_loop = k6.LAUNCHES["fused_axial_attention"]
        passes = MEDT_LAUNCHES["gated"]
        gated_run = dict(steps=steps, k7_launches=k7_loop, k6_launches=k6_loop, epoch_s=g_seconds,
                         train_loss=out[0][0], val_loss=out[2][0], val_dice=out[3][0],
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        log(f"main path: gated loop, one epoch of {steps} steps and {val_batches} validation "
            f"batches: K7 {k7_loop}, K6 {k6_loop}; {g_seconds:.2f} s, peak memory "
            f"{gated_run['peak_gib']:.2f} GiB")
        if k7_loop != dict.fromkeys(K7_GRIDS, passes * steps) or k6_loop != passes * val_batches:
            raise AssertionError(f"gated loop: K7 {k7_loop}, K6 {k6_loop}; expected "
                                 f"{passes * steps} a grid and {passes * val_batches}")
        del gated
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"training loop phase: {seconds:.1f} s")
    return dict(unet=unet, gated=gated_run, seconds=seconds)


def kernel_counters():
    """Every kernel wrapper module's LAUNCHES dict (each module of
    ``unet_zoo_tpu_torch.ops.kernels`` that has one)."""
    import importlib
    import pkgutil

    from unet_zoo_tpu_torch.ops import kernels

    mods = (importlib.import_module(f"{kernels.__name__}.{m.name}")
            for m in pkgutil.iter_modules(kernels.__path__))
    return [mod.LAUNCHES for mod in mods if hasattr(mod, "LAUNCHES")]


def member_model(torch, name, dtype, **kw):
    """``create_model(name)`` at its registry defaults, CORE_MEMBERS' options
    over them, from seed 0, with transatt_unet's PAM gamma at PAM_GAMMA."""
    from unet_zoo_tpu_torch import create_model

    model = create_model(name, dtype=dtype, seed=0, **CORE_MEMBERS.get(name, {}), **kw)
    if name == "transatt_unet":
        with torch.no_grad():
            model.module.pam.gamma.fill_(PAM_GAMMA)
    return model


def serve_core(torch, gen, device, name):
    """``name`` (``member_model``), served in bf16 through
    ``make_predictor`` at B=8/256px, against float32 compute on the same
    bf16-rounded weights: every output key finite and of the input's size,
    the main logits' rel L2 and mask agreement within CORE_REL_L2 and
    CORE_AGREE; img/s, device busy and idle share by the profiler, peak
    memory. No hand-written kernel runs on these float paths: every kernel
    counter must read 0 after the forward."""
    from unet_zoo_tpu_torch.utils.serving import make_predictor

    x = torch.randn(SERVE_BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
    bf16 = member_model(torch, name, torch.bfloat16)
    params = sum(p.numel() for p in bf16.module.parameters()) / 1e6
    pred = make_predictor(bf16, None, "logits")
    with torch.inference_mode():
        outs = bf16.module(x)
    for key, t in outs.items():
        if t.shape != (SERVE_BATCH, 1, IMAGE, IMAGE) or not torch.isfinite(t.float()).all():
            raise AssertionError(f"{name}: output {key} {tuple(t.shape)} is not finite logits "
                                 "of the input's size")
    del outs
    counters = kernel_counters()
    for counts in counters:
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lb = pred(x).float()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    f32 = member_model(torch, name, torch.float32)
    lf = make_predictor(f32, None, "logits")(x).float()
    del f32
    launches = {k: n for counts in counters for k, n in counts.items() if n}
    readings = dict(rel_l2_to_f32=rel_l2(torch, lb, lf),
                    mask_agreement_to_f32=((lb > 0) == (lf > 0)).float().mean().item())
    log(f"serve {name} ({params:.2f} M parameters): logits std "
        f"{lf.std().item():.4f}; bf16 against f32 compute rel L2 {readings['rel_l2_to_f32']:.3e} "
        f"(<= {CORE_REL_L2:.0e}), masks {readings['mask_agreement_to_f32']:.5f} "
        f"(>= {CORE_AGREE}); peak {peak:.2f} GiB; kernel launches {launches or 0} (0)")
    if launches or not (readings["rel_l2_to_f32"] <= CORE_REL_L2
                        and readings["mask_agreement_to_f32"] >= CORE_AGREE):
        raise AssertionError(f"{name}: bf16 serving strays from float32 compute")
    times = serve_times(torch, {"bf16": pred}, x)["bf16"]
    med = statistics.median(times)
    busy = breakdown(torch, name, lambda: pred(x), med)
    rate = SERVE_BATCH / (med / 1e3)
    log(f"serve {name} bf16 B={SERVE_BATCH} {IMAGE}px: {rate:.1f} img/s (forward median "
        f"{med:.4f} ms), busy {busy:.4f} ms, idle share {1 - busy / med:.3f}")
    return dict(parameters_m=params, serve_img_per_s=rate, forward_ms=med,
                device_busy_ms=busy, idle_share=1 - busy / med, peak_gib=peak, **readings)


def train_core(torch, gen, device, name, learning_rate=1e-3):
    """``name`` (``member_model``) trained in bf16 on float32 parameters
    through ``make_train_step`` for CORE_TRAIN_STEPS steps on one seeded
    B=8/256px batch: the loss must fall, and every output key must enter it
    at its spec's weight (``multi_output_loss`` read through a wrapper);
    train img/s over the steps after the first, peak memory. The step's
    dropout generator is re-seeded to DROPOUT_SEED before every step (the
    same units dropped each step, where the forward draws any)."""
    from unet_zoo_tpu_torch.train import steps as train_steps
    from unet_zoo_tpu_torch.train import create_train_state, make_train_step

    model = member_model(torch, name, torch.bfloat16)
    state = create_train_state(model, learning_rate=learning_rate)
    images, masks = train_batch(torch, gen, SERVE_BATCH, IMAGE, device)
    drop_gen = torch.Generator(device=device)
    weighted = []
    loss_fn = train_steps.multi_output_loss

    def recording(outputs, mask, weight_for, criterion):
        weighted.append({k: weight_for(k) for k in sorted(outputs)})
        return loss_fn(outputs, mask, weight_for, criterion)

    train_steps.multi_output_loss = recording
    try:
        step = make_train_step(model, generator=drop_gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, t0 = [], None
        for i in range(CORE_TRAIN_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            drop_gen.manual_seed(DROPOUT_SEED)
            losses.append(step(state, images, masks)["loss"])
        torch.cuda.synchronize()
        rate = SERVE_BATCH * (CORE_TRAIN_STEPS - 1) / (time.perf_counter() - t0)
    finally:
        train_steps.multi_output_loss = loss_fn
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = CORE_LOSS_WEIGHTS.get(name, {"main": 1.0})
    log(f"train {name} bf16 B={SERVE_BATCH} {IMAGE}px: losses {[round(v, 5) for v in losses]}, "
        f"{rate:.1f} img/s after the first step, peak {peak:.2f} GiB; keys and weights in the "
        f"loss {weighted[0]}")
    if weighted != [want] * CORE_TRAIN_STEPS:
        raise AssertionError(f"{name}: the loss weighted {weighted}, expected {want} a step")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    return dict(losses=losses, loss_weights=weighted[0], train_img_per_s=rate, peak_gib=peak)


def missformer_launch_shapes(image, batch=SERVE_BATCH):
    """K3's launch shapes in one missformer forward: rows of (B, H, W, C,
    launches). At stage s (image / 2^(s + 2)) the encoder's and the
    decoder's two MixFFN_skips a stage run on 4 x dims[s], and each of the
    bridge's four layers runs one on 4 x dims[0] at every scale."""
    rows = {}
    for s, d in enumerate(MISSFORMER_DIMS):
        hw = image >> (s + 2)
        for c in (4 * d, 4 * MISSFORMER_DIMS[0]):
            rows[(hw, c)] = rows.get((hw, c), 0) + 4
    return [(batch, hw, hw, c, n) for (hw, c), n in rows.items()]


def unext_moe_launch_shapes(image=IMAGE, batch=SERVE_BATCH):
    """K3's launch shapes in one unext_moe forward: the first MiT block of
    each stage (the second has the Switch-MoE FFN)."""
    return [(batch, image >> (s + 2), image >> (s + 2), 4 * d, 1)
            for s, d in enumerate(UNEXT_MOE_DIMS)]


def moe_drop_shares(module):
    """Each Switch-MoE block's share of its last forward's real tokens that
    were dropped at capacity, by module name."""
    from unet_zoo_tpu_torch.nn.moe import SwitchMoEMLP

    shares = {}
    for name, m in module.named_modules():
        if isinstance(m, SwitchMoEMLP) and m.last_routing is not None:
            kept = m.last_routing["kept"].reshape(-1)[:m.last_routing["tokens"]]
            shares[name] = 1.0 - kept.float().mean().item()
    return shares


def train_k3_carrier(torch, gen, device, name, image):
    """Registry-default ``name`` in bf16 on float32 parameters trained for
    CORE_TRAIN_STEPS steps at CARRIER_LR on one seeded B=8 batch at
    ``image`` through ``make_train_step``: the loss must fall and K3 must not
    launch (training runs the module path: K3 has no backward). One
    train-mode forward on the batch before the steps leaves the auxiliary
    losses that the step adds (unext_moe's load-balancing terms, one a MoE
    block), which must be finite; each MoE block's dropped share by step.
    Train img/s after the first step, peak memory."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.data import prepare_images
    from unet_zoo_tpu_torch.nn.moe import aux_loss_modules, pop_aux_losses
    from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
    from unet_zoo_tpu_torch.train import create_train_state, make_train_step

    model = create_model(name, dtype=torch.bfloat16, seed=0, image_size=image)
    state = create_train_state(model, learning_rate=CARRIER_LR)
    images, masks = train_batch(torch, gen, SERVE_BATCH, image, device)
    model.module.train()
    with torch.no_grad():
        model.module(prepare_images(images))
    aux = [float(t) for t in pop_aux_losses(aux_loss_modules(model.module))]
    step = make_train_step(model)
    k3.LAUNCHES["depthwise_conv2d"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, drops, t0 = [], [], None
    for i in range(CORE_TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(state, images, masks)["loss"])
        drops.append(moe_drop_shares(state.module))
    torch.cuda.synchronize()
    rate = SERVE_BATCH * (CORE_TRAIN_STEPS - 1) / (time.perf_counter() - t0)
    k3_launches = k3.LAUNCHES["depthwise_conv2d"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    log(f"train {name} bf16 B={SERVE_BATCH} {image}px: losses {[round(v, 5) for v in losses]}, "
        f"{rate:.1f} img/s after the first step, peak {peak:.2f} GiB, K3 launches {k3_launches} "
        f"(0); auxiliary losses of the batch before the steps {[round(t, 6) for t in aux]}"
        + (f"; dropped share a MoE block, first and last step {drops[0]}, {drops[-1]}"
           if drops[0] else ""))
    if k3_launches:
        raise AssertionError(f"{name}: K3 launched {k3_launches} times in training")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    if not all(map(math.isfinite, aux)):
        raise AssertionError(f"{name}: an auxiliary loss is not finite: {aux}")
    return dict(image=image, losses=losses, aux_losses=aux, drop_shares=drops,
                train_img_per_s=rate, peak_gib=peak, k3_launches=k3_launches)


def k3_carriers(torch, seeded, device):
    """Phase 23: K3 at the launch shapes missformer and unext_moe add; both
    served (missformer at 512px and 256px) and trained; K3 per launch shape
    of each served forward."""
    known = {row[:4] for name in UNEXT_CONFIGS for row in unext_launch_shapes(name)}
    shapes = {image: missformer_launch_shapes(image) for image in MISSFORMER_IMAGES}
    fresh = sorted({row[:4] for rows in shapes.values() for row in rows} - known,
                   key=lambda r: (-r[1], r[3]))
    err = check_k3(torch, seeded("check_k3", "carriers"), device, fresh)
    served = {f"missformer_{image}px": serve_k3_carrier(
        torch, seeded("serve_k3_carrier", "missformer", image), device, "missformer", image,
        MISSFORMER_LAUNCHES, MISSFORMER_REL_L2, MISSFORMER_AGREE, MISSFORMER_F32_RATIO)
        for image in MISSFORMER_IMAGES}
    torch.cuda.empty_cache()
    served["unext_moe"] = serve_k3_carrier(
        torch, seeded("serve_k3_carrier", "unext_moe"), device, "unext_moe", IMAGE,
        UNEXT_MOE_LAUNCHES, UNEXT_REL_L2, UNEXT_AGREE, UNEXT_F32_RATIO)
    if len(served["unext_moe"]["drop_shares"]) != len(UNEXT_MOE_DIMS):
        raise AssertionError(f"unext_moe: served routing of {served['unext_moe']['drop_shares']},"
                             f" expected one a MoE block")
    rows = {f"missformer_{image}px": time_k3(torch, seeded("time_k3", "missformer", image),
                                             device, "missformer", shapes[image])
            for image in MISSFORMER_IMAGES}
    rows["unext_moe"] = time_k3(torch, seeded("time_k3", "unext_moe"), device, "unext_moe",
                                unext_moe_launch_shapes())
    torch.cuda.empty_cache()
    trained = {"missformer": train_k3_carrier(torch, seeded("train_k3_carrier", "missformer"),
                                              device, "missformer", IMAGE)}
    torch.cuda.empty_cache()
    trained["unext_moe"] = train_k3_carrier(torch, seeded("train_k3_carrier", "unext_moe"),
                                            device, "unext_moe", IMAGE)
    if [len(trained[n]["aux_losses"]) for n in ("missformer", "unext_moe")] != \
            [0, len(UNEXT_MOE_DIMS)]:
        raise AssertionError("a training forward did not leave one load-balancing loss a MoE "
                             "block (and none in missformer)")
    torch.cuda.empty_cache()
    per_config = {}
    for key, r in rows.items():
        b = bound(0, per_forward(r, "bytes"), per_forward(r, "f32_ops"))
        per_config[key] = dict(launches=served[key]["launches"], ms=per_forward(r, "ms"),
                               events_ms=per_forward(r, "events_ms"),
                               host_us=per_forward(r, "host_us"),
                               plain_ms=per_forward(r, "plain_ms"),
                               module_chain_ms=per_forward(r, "module_chain_ms"),
                               library_ms=per_forward(r, "library_ms"),
                               bound_ms=b[0], bound_by=b[1])
        log(f"K3 per {key} forward: {per_config[key]}")
    return dict(max_abs_err=err, served=served, trained=trained, per_config=per_config,
                shapes=rows)


def conv_members(torch, seeded, device):
    """Phase 24: the convolutional members (CONV_MEMBERS) served in bf16 at
    B=8/256px against float32 compute (``serve_core``: no kernel launches,
    phase 22's bars) and trained CORE_TRAIN_STEPS steps at CARRIER_LR
    (``train_core``); raunet's vendored encoder decoded first, cold, and
    timed (its int8 members run with 17-20)."""
    from unet_zoo_tpu_torch.utils import pretrained

    t0 = time.perf_counter()
    sd, meta = pretrained.vendored_encoder(pretrained.VENDORED_RAUNET_ENCODER)
    load_s = time.perf_counter() - t0
    log(f"raunet: the vendored encoder ({len(sd)} tensors, task {meta.get('task')!r}) read and "
        f"decoded in {load_s:.3f} s")
    t0 = time.perf_counter()
    member_model(torch, "raunet", torch.bfloat16)
    create_s = time.perf_counter() - t0
    log(f"raunet: create_model with the encoder overlaid in {create_s:.3f} s")
    served, trained = {}, {}
    for name in CONV_MEMBERS:
        served[name] = serve_core(torch, seeded("serve_conv", name), device, name)
        torch.cuda.empty_cache()
    for name in CONV_MEMBERS:
        trained[name] = train_core(torch, seeded("train_conv", name), device, name, CARRIER_LR)
        torch.cuda.empty_cache()
    return dict(raunet_encoder_load_s=load_s, raunet_create_s=create_s, serving=served,
                training=trained)


def mma_counts(build, stem="int8_gemm"):
    """Counts of the int8 (IGMMA) and bf16 (HGMMA) wgmma instructions and of
    the mma.sync (HMMA) instructions in ``cuobjdump -sass`` of the built
    library ``stem`` (P2's by default)."""
    import os

    lib = build.build_all()[stem]
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return {op: sum(op in line for line in sass.splitlines())
            for op in ("IGMMA", "HGMMA", "HMMA")}


def phase_gen(torch, device, *name):
    """A generator for one phase of the run, seeded from the phase's name, so
    that a draw added to or taken from one phase moves no other phase's
    inputs."""
    return torch.Generator(device=device).manual_seed(zlib.crc32(" ".join(map(str, name)).encode()))


def per_forward(rows, key):
    """A per-launch quantity summed over one forward's launches."""
    return sum(r[key] * r["launches"] for r in rows)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.ops.kernels import build
    from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
    from unet_zoo_tpu_torch.utils.serving import make_predictor

    # the f32 reference is exact f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build every kernel from source
    t0 = time.perf_counter()
    paths = build.build_all()
    t_built = time.perf_counter()
    log(f"build: {sorted(paths)} in {t_built - t0:.1f} s")
    for stem in paths:
        ptxas = (build.BUILD_DIR / f"{stem}.log")
        if ptxas.exists():
            log(ptxas.read_text().strip())

    # 3. K1 against its plain version
    seeded = lambda *name: phase_gen(torch, device, *name)
    max_err = check_k1(torch, seeded("k1"), device)

    # 4. serve unet at full width, kernel path vs plain module path
    x = torch.randn(SERVE_BATCH, 3, IMAGE, IMAGE, generator=seeded("serve unet"),
                    device=device)
    kern = create_model("unet", dtype=torch.bfloat16, seed=0)
    plain = create_model("unet", dtype=torch.bfloat16, seed=0, use_kernels=False)
    pred_k, pred_p = make_predictor(kern, None, "logits"), make_predictor(plain, None, "logits")

    k1.LAUNCHES["fused_up_concat_conv"] = 0
    logits_k = pred_k(x)
    torch.cuda.synchronize()
    launches = k1.LAUNCHES["fused_up_concat_conv"]
    logits_p = pred_p(x)
    mask_k = make_predictor(kern, None, "mask")(x)
    mask_p = make_predictor(plain, None, "mask")(x)
    torch.cuda.synchronize()
    log(f"main path: K1 launches {launches} in one forward")
    if launches != len(STAGES):
        raise AssertionError(f"K1 ran {launches} times, expected {len(STAGES)}")
    for t in (logits_k, logits_p):
        assert t.shape == (SERVE_BATCH, 1, IMAGE, IMAGE) and torch.isfinite(t.float()).all()
    lk, lp = logits_k.float(), logits_p.float()
    rel_l2 = ((lk - lp).norm() / lp.norm()).item()
    agree = (mask_k == mask_p).float().mean().item()
    log(f"serve: logits std {lp.std().item():.4f}, rel L2 kernel vs plain {rel_l2:.3e} "
        f"(<= 1e-2), mask agreement {agree:.5f} (>= 0.99)")
    if not (rel_l2 <= 1e-2 and agree >= 0.99):
        raise AssertionError("kernel path disagrees with the plain path")

    # the profiler sees K1's two grids once per decoder stage
    kernels = [e for e in profile_forward(torch, lambda: pred_k(x)) if "fused_up_" in e.name]
    kernels.sort(key=lambda e: e.time_range.start)
    convt = [e for e in kernels if "fused_up_convt_kernel" in e.name]
    conv3 = [e for e in kernels if "fused_up_conv3x3_kernel" in e.name]
    log(f"profiler: {len(convt)} ConvT grids, {len(conv3)} conv3x3 grids: "
        + ", ".join(f"{a.time_range.elapsed_us():.1f}+{c.time_range.elapsed_us():.1f} us"
                    for a, c in zip(convt, conv3)))
    if len(convt) != len(STAGES) or len(conv3) != len(STAGES):
        raise AssertionError(f"profiler did not see K1 on every decoder stage: {len(convt)} "
                             f"ConvT and {len(conv3)} conv3x3 grids")

    # serving rate, both paths, in turns; each sample is 3 forwards back to back
    times = serve_times(torch, {"kernel": pred_k, "plain": pred_p}, x)
    med = {k: statistics.median(v) for k, v in times.items()}
    rates = {k: SERVE_BATCH / (m / 1e3) for k, m in med.items()}
    for name in ("kernel", "plain"):
        q = statistics.quantiles(times[name], n=4)
        log(f"serve unet bf16 B={SERVE_BATCH} {IMAGE}px, {name} path: {rates[name]:.1f} img/s "
            f"(forward median {med[name]:.4f} ms, quartiles {q[0]:.4f}-{q[2]:.4f} ms)")

    # where a forward's device time goes, by kernel, on each path
    for name, fn in (("kernel", pred_k), ("plain", pred_p)):
        breakdown(torch, name, lambda: fn(x), med[name])

    # each stage at the serving shapes: K1, its plain version, the cuDNN chain
    stages = []
    for cin, cu, hc in STAGES:
        b, cs, co = SERVE_BATCH, cu, cu
        args = stage_case(torch, seeded("time k1", cin), b, cin, cu, cs, co, hc, hc, device)
        y, skip, wt, bt, wc, sc, bi = args
        wt4 = wt.reshape(cin, 2, 2, cu).permute(0, 3, 1, 2).contiguous()
        wc4 = wc.reshape(3, 3, cu + cs, co).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bt16, sc4, bi4 = bt.to(torch.bfloat16), sc.view(1, -1, 1, 1), bi.view(1, -1, 1, 1)

        def chain():
            up = F.conv_transpose2d(y, wt4, bt16, stride=2)
            z = F.conv2d(torch.cat([up, skip], dim=1), wc4, padding=1)
            return torch.relu(z.float() * sc4 + bi4).to(torch.bfloat16)

        packed = k1.pack_kernel_weights(wt, wc)
        ms = cuda_ms(torch, lambda: k1.fused_up_concat_conv(*args, packed), 20)
        graph = graph_ms(torch, lambda: k1.fused_up_concat_conv(*args, packed), 20)
        plain_ms = cuda_ms(torch, lambda: k1.fused_up_concat_conv_reference(*args), 5)
        chain_ms = cuda_ms(torch, chain, 20)
        flops, nbytes = work(b, cin, cu, cs, co, hc, hc)
        bound_ms, bound_by = bound(flops, nbytes)
        stages.append(dict(y=[b, cin, hc, hc], skip=[b, cs, 2 * hc, 2 * hc], co=co,
                           flops=flops, bytes=nbytes, ms=ms, graph_ms=graph, plain_ms=plain_ms,
                           cudnn_chain_ms=chain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           tflops=flops / ms / 1e9))
        log(f"stage y={[b, cin, hc, hc]}: K1 {ms:.4f} ms by events, {graph:.4f} ms by graph "
            f"({flops / graph / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, cuDNN chain {chain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    log(f"K1 per unet forward: {sum(r['ms'] for r in stages):.4f} ms by events, "
        f"{sum(r['graph_ms'] for r in stages):.4f} ms by graph, bound "
        f"{sum(r['bound_ms'] for r in stages):.4f} ms")
    t_phase = lap("unet (K1)", t_built)

    # 17-20. int8 serving through P2's conv (unet_tpu, unet, and phase 22's
    # attention_unet), P2's GEMM and P1's gather on their probes' paths, run
    # here, early: late in the run the profiler kept losing one P2 grid of the
    # float32 unet's trace and of attention_unet's, which traces of the same
    # forward in a fresh process hold
    p2_conv_err = check_int8_conv(torch, seeded("check_int8_conv"), device)
    int8_serving = {name: serve_int8(torch, seeded("serve_int8", name), device, name) for name in INT8_LAUNCHES}
    p2_timed = {name: time_int8_conv(torch, seeded("time_int8_conv", name), device, name) for name in INT8_LAUNCHES}
    p2_rows = {name: rows for name, (rows, _) in p2_timed.items()}
    torch.cuda.empty_cache()
    gemm = check_gemm(torch, seeded("check_gemm"), device)
    gather = check_gather(torch, seeded("check_gather"), device)
    t_phase = lap("int8 (P2, P1)", t_phase)

    # 5-6. mmunet: K4 and K5 checks, serving, per-shape timings
    k4_err, k5_err = check_k4_k5(torch, seeded("check_k4_k5"), device)
    mm_launches, mm_rates, mm_med, mm_busy, mm_agreement = serve_mmunet(torch, seeded("serve_mmunet"), device)
    k4_rows, k5_rows = time_k4_k5(torch, seeded("time_k4_k5"), device)
    t_phase = lap("mmunet (K4, K5)", t_phase)

    # 7-8. MedT: K6 checks, gated served at full width, the other four names
    # at B=2/128px, K6 per launch shape
    k6_err = check_k6(torch, seeded("check_k6"), device)
    gated = serve_medt(torch, seeded("serve_medt", "gated"), device, "gated", SERVE_BATCH, IMAGE, profile=True)
    others = {name: serve_medt(torch, seeded("serve_medt", name), device, name, 2, 128, profile=False)
              for name in ("axialunet", "medt", "logo", "medt_logo")}
    k6_rows, k6_wopos = time_k6(torch, seeded("time_k6"), device)
    torch.cuda.empty_cache()
    t_phase = lap("MedT serving (K6)", t_phase)

    # 9-10. MedT training: K7 checks, gated trained at full width on both
    # paths, axialunet briefly at 128px, K7 per launch shape
    k7_err, k7_worst = check_k7(torch, seeded("check_k7"), device)
    gated_train = train_paths(torch, seeded("train_paths", "gated"), device, "gated", SERVE_BATCH, IMAGE, TRAIN_STEPS,
                              profile=True)
    torch.cuda.empty_cache()
    noise = {str(layers or "registry"): grad_noise(torch, device, SERVE_BATCH, IMAGE, layers)
             for layers in (None, (1, 1, 1, 1))}
    axialunet_train = train_paths(torch, seeded("train_paths", "axialunet"), device, "axialunet", 2, 128, 3, profile=False)
    k7_rows = time_k7(torch, seeded("time_k7"), device)
    torch.cuda.empty_cache()
    t_phase = lap("MedT training (K7)", t_phase)

    # 11-12. swin_unet_v2: K2 checks, both configurations served at full
    # width, K2 per launch shape
    k2_err = check_k2(torch, seeded("check_k2"), device)
    swin = {f"{image}px": serve_swin(torch, seeded("serve_swin", image), device, image, window)
            for image, window in SWIN_CONFIGS}
    k2_rows = {f"{image}px": time_k2(torch, seeded("time_k2", image), device, image, window)
               for image, window in SWIN_CONFIGS}
    torch.cuda.empty_cache()
    t_phase = lap("swin_unet_v2 (K2)", t_phase)

    # 13-14. unext and unext_s: K3 checks, both served at full width, K3 per
    # launch shape
    k3_err = check_k3(torch, seeded("check_k3"), device)
    unext = {name: serve_k3_carrier(torch, seeded("serve_unext", name), device, name, IMAGE,
                                    UNEXT_LAUNCHES[name], UNEXT_REL_L2, UNEXT_AGREE,
                                    UNEXT_F32_RATIO) for name in UNEXT_CONFIGS}
    k3_rows = {name: time_k3(torch, seeded("time_k3", name), device, name) for name in UNEXT_CONFIGS}
    torch.cuda.empty_cache()
    t_phase = lap("unext (K3)", t_phase)

    # 15-16. wranet: K8 checks, served at full width, K8 per launch shape
    k8_err = check_k8(torch, seeded("check_k8"), device)
    wranet = serve_wranet(torch, seeded("serve_wranet"), device)
    k8_rows = time_k8(torch, seeded("time_k8"), device)
    torch.cuda.empty_cache()
    t_phase = lap("wranet (K8)", t_phase)

    # 21. the training loop: unet (K1 in every validation pass) and gated (K7
    # in every step, K6 in every validation batch) through train_model
    loop = train_loop(torch, device)
    t_phase = lap("training loop (K1, K6, K7)", t_phase)

    # 22. the BASELINE core members: six names served at full width in bf16,
    # u2net and nested_unet trained (int8 attention_unet ran with 17-20)
    core = {name: serve_core(torch, seeded("serve_core", name), device, name)
            for name in CORE_MEMBERS}
    torch.cuda.empty_cache()
    core_train = {name: train_core(torch, seeded("train_core", name), device, name)
                  for name in CORE_TRAIN}
    torch.cuda.empty_cache()
    t_phase = lap("core members", t_phase)

    # 23. the K3 carriers of this slice: missformer (512px and 256px) and
    # unext_moe served and trained, K3 at the launch shapes they add
    carriers = k3_carriers(torch, seeded, device)
    t_phase = lap("K3 carriers (missformer, unext_moe)", t_phase)

    # 24. the convolutional members: raunet, transatt_unet, unet_transformer,
    # multiresunet and vnet served and trained (their int8 ran with 17-20)
    conv = conv_members(torch, seeded, device)
    lap("conv members (P2)", t_phase)

    p2_per_model = {}
    for name, rows in p2_rows.items():
        b = bound(0, per_forward(rows, "bytes"), int8_ops=per_forward(rows, "int8_ops"))
        p2_per_model[name] = dict(launches=int8_serving[name]["launches"],
                                  ms=per_forward(rows, "ms"), plain_ms=per_forward(rows, "plain_ms"),
                                  cudnn_bf16_ms=per_forward(rows, "cudnn_bf16_ms"),
                                  int8_ops=per_forward(rows, "int8_ops"), bound_ms=b[0],
                                  bound_by=b[1], host_us_per_launch=p2_timed[name][1])
        log(f"P2 conv per {name} forward: {p2_per_model[name]}")

    total = lambda key: sum(s[key] for s in stages)
    bound_ms, bound_by = bound(total("flops"), total("bytes"))
    k4_bound = bound(per_forward(k4_rows, "tc_flops"), per_forward(k4_rows, "bytes"),
                     per_forward(k4_rows, "f32_flops"))
    k4_grids = {}
    for r in k4_rows:
        for name, g in r["grids_ms"].items():
            k4_grids[name] = k4_grids.get(name, 0.0) + g * r["launches"]
    log(f"K4 per mmunet forward: {per_forward(k4_rows, 'ms'):.4f} ms by events, "
        f"{per_forward(k4_rows, 'graph_ms'):.4f} ms by graph, device "
        f"{per_forward(k4_rows, 'device_ms'):.4f} ms ("
        + ", ".join(f"{name} {g:.4f}" for name, g in k4_grids.items())
        + f"), bound {k4_bound[0]:.4f} ms ({k4_bound[1]})")
    k5_bound = bound(0, per_forward(k5_rows, "bytes"), per_forward(k5_rows, "f32_ops"))
    k5_grids = {}
    for r in k5_rows:
        for name, g in r["grids_ms"].items():
            k5_grids[name] = k5_grids.get(name, 0.0) + g * r["launches"]
    log(f"K5 per mmunet forward: {per_forward(k5_rows, 'ms'):.4f} ms by events, "
        f"{per_forward(k5_rows, 'graph_ms'):.4f} ms by graph, device "
        f"{per_forward(k5_rows, 'device_ms'):.4f} ms ("
        + ", ".join(f"{name} {g:.4f}" for name, g in k5_grids.items())
        + f"), bound {k5_bound[0]:.4f} ms ({k5_bound[1]})")
    mm_serving = dict(serve_img_per_s=mm_rates, forward_ms=mm_med, device_busy_ms=mm_busy,
                      **mm_agreement)
    k6_bound = bound(0, per_forward(k6_rows, "bytes"), per_forward(k6_rows, "f32_ops"))
    log(f"K6 per gated forward: {per_forward(k6_rows, 'ms'):.4f} ms by events, "
        f"{per_forward(k6_rows, 'graph_ms'):.4f} ms by graph, bound {k6_bound[0]:.4f} ms "
        f"({k6_bound[1]})")
    k7_bound = bound(0, per_forward(k7_rows, "bytes"), per_forward(k7_rows, "f32_ops"))
    main_k2 = k2_rows["224px"]        # the registry default: 224px, window 7
    k2_bound = bound(per_forward(main_k2, "tc_flops"), per_forward(main_k2, "bytes"),
                     per_forward(main_k2, "f32_ops"))
    k2_per_config = {}
    for key, rows in k2_rows.items():
        b = bound(per_forward(rows, "tc_flops"), per_forward(rows, "bytes"),
                  per_forward(rows, "f32_ops"))
        k2_per_config[key] = dict(ms=per_forward(rows, "ms"), graph_ms=per_forward(rows, "graph_ms"),
                                  plain_ms=per_forward(rows, "plain_ms"),
                                  module_chain_ms=per_forward(rows, "module_chain_ms"),
                                  bound_ms=b[0], bound_by=b[1])
        log(f"K2 per {key} forward: {k2_per_config[key]}")
    k3_per_config = {}
    for name, rows in k3_rows.items():
        b = bound(0, per_forward(rows, "bytes"), per_forward(rows, "f32_ops"))
        k3_per_config[name] = dict(launches=unext[name]["launches"], ms=per_forward(rows, "ms"),
                                   events_ms=per_forward(rows, "events_ms"),
                                   host_us=per_forward(rows, "host_us"),
                                   plain_ms=per_forward(rows, "plain_ms"),
                                   module_chain_ms=per_forward(rows, "module_chain_ms"),
                                   library_ms=per_forward(rows, "library_ms"),
                                   bound_ms=b[0], bound_by=b[1])
        log(f"K3 per {name} forward: {k3_per_config[name]}")
    k8_bound = bound(per_forward(k8_rows, "tc_flops"), per_forward(k8_rows, "bytes"),
                     per_forward(k8_rows, "f32_ops"))
    log(f"K8 per wranet forward: {per_forward(k8_rows, 'ms'):.4f} ms by graph, "
        f"{per_forward(k8_rows, 'events_ms'):.4f} ms by events, the blend's issue floor "
        f"{sum(k8_issue_ms(r['b'], r['h'], r['w'], r['c']) * r['launches'] for r in k8_rows):.4f}"
        f" ms, plain "
        f"{per_forward(k8_rows, 'plain_ms'):.4f} ms, module chain "
        f"{per_forward(k8_rows, 'module_chain_ms'):.4f} ms, bound {k8_bound[0]:.4f} ms "
        f"({k8_bound[1]})")
    gmma = mma_counts(build)
    log(f"P2: {gmma} wgmma instructions in cuobjdump -sass of the built int8_gemm library")
    if not (gmma["IGMMA"] and gmma["HGMMA"]):
        raise AssertionError(f"the built P2 library holds no wgmma of a type: {gmma}")
    k1_gmma = mma_counts(build, "fused_up")
    log(f"K1: {k1_gmma} wgmma instructions in cuobjdump -sass of the built fused_up library")
    if not k1_gmma["HGMMA"]:
        raise AssertionError(f"the built K1 library holds no bf16 wgmma: {k1_gmma}")
    k2_mma = mma_counts(build, "window_attention")
    log(f"K2: {k2_mma} tensor-core instructions in cuobjdump -sass of the built "
        f"window_attention library")
    if not k2_mma["HMMA"]:
        raise AssertionError(f"the built K2 library holds no mma.sync: {k2_mma}")
    log(f"profiler: {PROFILE_RETAKES[0]} traces retaken after a trace that lost records")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to the kernels line")
    log(json.dumps({"kernels": [{
        "name": "fused_up_concat_conv",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/fused_up.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/fused_up.py:192",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total("ms"),
        "graph_ms": total("graph_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "cudnn_chain_ms": total("cudnn_chain_ms"),
        "loop_launches": loop["unet"]["k1_launches"],
        "training_loop": loop,
        "serve_img_per_s": rates,
        "stages": stages,
    }, {
        "name": "fused_mkblock",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/mkblock.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/mkblock.py:149",
        "launches": mm_launches["fused_mkblock"],
        "max_abs_err": k4_err,
        "ms": per_forward(k4_rows, "ms"),
        "plain_ms": per_forward(k4_rows, "plain_ms"),
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        "library_ms": None,
        "module_chain_ms": per_forward(k4_rows, "module_chain_ms"),
        "graph_ms": per_forward(k4_rows, "graph_ms"),
        "device_ms": per_forward(k4_rows, "device_ms"),
        "grids_ms": k4_grids,
        "mmunet": mm_serving,
        "shapes": k4_rows,
    }, {
        "name": "fused_softmax_morph",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/morph.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/morph.py:109",
        "launches": mm_launches["fused_softmax_morph"],
        "max_abs_err": k5_err,
        "ms": per_forward(k5_rows, "ms"),
        "plain_ms": per_forward(k5_rows, "plain_ms"),
        "bound_ms": k5_bound[0],
        "bound_by": k5_bound[1],
        "library_ms": None,
        "module_chain_ms": per_forward(k5_rows, "module_chain_ms"),
        "graph_ms": per_forward(k5_rows, "graph_ms"),
        "device_ms": per_forward(k5_rows, "device_ms"),
        "grids_ms": k5_grids,
        "shapes": k5_rows,
    }, {
        "name": "fused_axial_attention",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/axial_attention.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/axial_attention.py:82",
        "launches": gated["launches"],
        "max_abs_err": k6_err,
        "ms": per_forward(k6_rows, "ms"),
        "plain_ms": per_forward(k6_rows, "plain_ms"),
        "graph_ms": per_forward(k6_rows, "graph_ms"),
        "bound_ms": k6_bound[0],
        "bound_by": k6_bound[1],
        "library_ms": None,
        "module_chain_ms": per_forward(k6_rows, "module_chain_ms"),
        "loop_launches": loop["gated"]["k6_launches"],
        "gated": gated,
        "others": others,
        "wopos": k6_wopos,
        "shapes": k6_rows,
    }, {
        "name": "fused_axial_train",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/axial_train.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/axial_train.py:209",
        "launches": sum(gated_train["launches"].values()),
        "max_abs_err": k7_err,
        "ms": per_forward(k7_rows, "ms"),
        "plain_ms": per_forward(k7_rows, "plain_ms"),
        "bound_ms": k7_bound[0],
        "bound_by": k7_bound[1],
        "library_ms": None,
        "fwd_ms": per_forward(k7_rows, "fwd_ms"),
        "bwd_ms": per_forward(k7_rows, "bwd_ms"),
        "autograd_ms": per_forward(k7_rows, "autograd_ms"),
        "module_chain_ms": per_forward(k7_rows, "module_chain_ms"),
        "kernel_chain_ms": per_forward(k7_rows, "kernel_chain_ms"),
        "loop_launches": sum(loop["gated"]["k7_launches"].values()),
        "readings_max": k7_worst,
        "gated_train": gated_train,
        "gated_grad_noise": noise,
        "axialunet_train": axialunet_train,
        "shapes": k7_rows,
    }, {
        "name": "swin_window_attention",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/window_attention.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/window_attention.py:77",
        "launches": swin["224px"]["launches"],
        "max_abs_err": k2_err,
        "ms": per_forward(main_k2, "ms"),
        "graph_ms": per_forward(main_k2, "graph_ms"),
        "plain_ms": per_forward(main_k2, "plain_ms"),
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
        "module_chain_ms": per_forward(main_k2, "module_chain_ms"),
        "per_config": k2_per_config,
        "swin_unet_v2": swin,
        "shapes": k2_rows,
    }, {
        "name": "depthwise_conv2d",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/depthwise.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/depthwise.py:66",
        "launches": unext["unext"]["launches"],
        "max_abs_err": max(k3_err, carriers["max_abs_err"]),
        "ms": k3_per_config["unext"]["ms"],
        "events_ms": k3_per_config["unext"]["events_ms"],
        "plain_ms": k3_per_config["unext"]["plain_ms"],
        "bound_ms": k3_per_config["unext"]["bound_ms"],
        "bound_by": k3_per_config["unext"]["bound_by"],
        "library_ms": k3_per_config["unext"]["library_ms"],
        "module_chain_ms": k3_per_config["unext"]["module_chain_ms"],
        "per_config": {**k3_per_config, **carriers["per_config"]},
        "carrier_shapes_max_abs_err": carriers["max_abs_err"],
        "unext": unext,
        "carriers": {"served": carriers["served"], "trained": carriers["trained"]},
        "shapes": {**k3_rows, **carriers["shapes"]},
    }, {
        "name": "deform_conv2d",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/deform.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/deform.py:100",
        "launches": wranet["launches"],
        "max_abs_err": k8_err,
        "ms": per_forward(k8_rows, "ms"),
        "plain_ms": per_forward(k8_rows, "plain_ms"),
        "bound_ms": k8_bound[0],
        "bound_by": k8_bound[1],
        "library_ms": None,
        "events_ms": per_forward(k8_rows, "events_ms"),
        "module_chain_ms": per_forward(k8_rows, "module_chain_ms"),
        "wranet": wranet,
        "shapes": k8_rows,
    }, {
        "name": "int8_conv3x3",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/int8_gemm.cu",
        "replaces": "_probe_int8_mosaic.py:34",
        "launches": int8_serving["unet_tpu"]["launches"],
        "max_abs_err": p2_conv_err,
        "ms": p2_per_model["unet_tpu"]["ms"],
        "plain_ms": p2_per_model["unet_tpu"]["plain_ms"],
        "bound_ms": p2_per_model["unet_tpu"]["bound_ms"],
        "bound_by": p2_per_model["unet_tpu"]["bound_by"],
        "library_ms": None,
        "cudnn_bf16_ms": p2_per_model["unet_tpu"]["cudnn_bf16_ms"],
        "sass_wgmma": gmma,
        "per_model": p2_per_model,
        "serving": int8_serving,
        "shapes": p2_rows,
        "core_members": {"serving": core, "training": core_train},
        "conv_members": conv,
    }, {
        "name": "matmul",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/int8_gemm.cu",
        "replaces": "_probe_int8_mosaic.py:34",
        "launches": gemm["launches"],
        "max_abs_err": 0.0 if gemm["s8_bit_for_bit"] else None,
        "ms": gemm["s8"]["ms"],
        "plain_ms": gemm["s8"]["plain_ms"],
        "bound_ms": gemm["s8"]["bound_ms"],
        "bound_by": gemm["s8"]["bound_by"],
        "library_ms": gemm["s8"]["library_ms"],
        "gemm": gemm,
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/row_gather.cu",
        "replaces": "_probe_gather.py:44",
        "launches": gather["launches"],
        "max_abs_err": gather["max_abs_err"],
        "ms": gather["ms"],
        "plain_ms": gather["plain_ms"],
        "bound_ms": gather["bound_ms"],
        "bound_by": gather["bound_by"],
        "library_ms": gather["library_ms"],
        "probe": gather["probe"],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
