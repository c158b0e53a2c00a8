#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (lushnerf_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, in order (any failure makes the exit code non-zero and suppresses
the final result line):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build: the CUDA sources with nvcc for sm_90a, printing registers and
     spills: nerf_mlp_fwd.cu, nerf_mlp_bwd.cu and nerf_mlp_dgrad.cu at MLP
     width 256, three processes side by side (this process takes the
     first Adam's imports meanwhile); then, at the lowest CPU priority
     beside phases 3 to 7, the same three at width 128, the dgrads' build
     for a PE part of 128 channels (nerf_mlp_dgrad_wide.cu) at both widths,
     nerf_pe_mm.cu, raymajor_probe.cu and the tune phase's three K4
     variants (`build_rest`, waited for after phase 7, before the first
     phase that launches one of them);
  3. kernel: the fused NeRF-MLP forward kernel against its plain PyTorch
     version at width 256 / depth 8, at the flagship point counts 5120x64
     and 5120x128 (forward_kernel), 4096x64 and 4096x128 (a render_image
     chunk), the trainer phase's 1024x64 and 1024x128 (a naive step) and
     8192x128 (an eval chunk; its 8192x64 is the render chunk's 4096x128),
     the cte phase's consist pass, 800x64 and 800x128 (CTE_RAYS: 32 pixels
     in each of 25 train views), at a ragged and an odd tile count and at
     one point, each launch
     repeated and compared bit for bit; median kernel and plain times from
     CUDA events, and the share of the limit each row uses.  f32 (the split
     on the tensor cores; its bound is three bf16-rate passes, the f32 FMA
     bound printed beside it): rtol 1e-4, atol 1e-5.  bf16: rtol 1e-3, atol 1e-3 on
     each value (the same bf16 roundings, but sums in another order move
     some activations to the neighbouring bf16 value), and (from two
     points on) a mean error at most a tenth of the mean gap between the
     plain version in f32 and in bf16, so that a kernel that skipped the
     bf16 rounding would fail.  A yardstick beside it: K1's nine 256-wide
     products through torch.matmul in bf16 at 5120x128;
  4. kernel_bwd: the forward kernel with its activation stash (K1), the
     stash backward (K2) and the remat backward (K3) against
     nerf_mlp_fwd_plain / nerf_mlp_bwd_plain at the flagship P, the
     trainer phase's naive P (1024x64, one point chunk, and 1024x128),
     the cte phase's consist P (800x64, one chunk, and 800x128, two),
     a ragged P and one point, f32 and bf16: the stash launch's output as phase 3
     holds it; its stash block by block within STASH_TOL (in bf16 also a
     mean error at most a tenth of the plain f32-vs-bf16 stash gap); d(xd)
     and the grads
     of all 24 parameters from K2 on the kernel's stash and on the plain
     forward's stash, each tensor's max error over its max magnitude within
     BWD_TOL, in bf16 also each tensor's mean error at most a tenth of the
     plain f32-vs-bf16 mean gap (not at one point); a second run gives the
     same bits; K2 and K3 agree to the bit; in f32 the backward at g 2^-20
     gives 2^-20 times its grads at g, bit for bit (the f32 dgrad's split
     carries a power-of-two scale per point, the f32 wgrad's one per point
     split and d_z block), the dgrad's scale units of dz equal
     `dz_scale_units` of its dz bit for bit, and K1's scale units of its
     stash equal `stash_scale_units` of the stash bit for bit; in f32 also
     a row at the flagship coarse P with a cotangent shaped like the
     shipped step's (half the points 0, |g| log-uniform over
     2^-28..2^-17); at the coarse, the naive fine and the consist fine P
     in both dtypes K2 and K3 at point_chunk
     POINT_CHUNK (scratch one chunk in size) against K2 in one chunk and
     against the plain backward within BWD_TOL, repeated and stash against
     remat bit for bit; last, K1 f32 (output only and with the stash), K2
     and K3 f32 at the coarse P on an MLP whose biases put activations past
     fp16's 65504 (`large_activation_mlp`): finite, within KERNEL_TOL /
     STASH_TOL of the plain forward and BWD_TOL of the plain backward in
     f64 (at a cotangent |N(0, 1)|; the random-sign cotangent's errors of
     the kernel and of the plain f32 backward against f64 printed beside),
     K3 the bits of K2, the units those of `stash_scale_units`; in both dtypes
     the dgrad and the wgrad with its reductions timed apart at both
     flagship P, each with its byte and operations bounds (f32: both as the
     split), beside the wgrad its 12 weight blocks through torch.mm (12
     calls, a yardstick), and the dgrad's time by stage from the clock64
     stamps of an instrumented instantiation (f32: also its PE warps'
     cycles by task), and the wgrad's cycles in its consumers and its
     converters (f32) or its TMA producer (bf16), `wgrad stages at P =
     ...`; so the forward's too, f32 and bf16, output only and with the
     stash; in bf16 at every P also the wgrad's weight grads against the
     plain f32 products of its own dz, stash and PE scratch, tile by tile
     within WGRAD_ALONE_TOL;
  5. forward_kernel: the flagship config (29 images, 1024 rays x 5
     sub-rays, 400x400, focal 320) -- finite outputs, exactly 2 kernel
     launches per call, agreement with the plain-torch backend on the
     same random draws, and the time per call of both backends over a
     window of back-to-back calls with one synchronize at its end (as every
     host-clock metric here; the median, min and max of calls synchronised
     one by one are printed beside it);
  6. render_image: one 400x400 view at ray_chunk 4096 (40 chunks, 80
     launches), bf16 and f32, compared with and timed against the same
     render through mlp_backend='torch';
  7. train_step: the flagship train step (Adam, lrate 5e-4) in stages
     kernel (with fq_mask), allkernel and naive, one step each, with the
     launches and parameter packings per step counted; 20 kernel steps on a
     fixed batch and fixed draws, whose loss must fall; ms/step (a window
     of 2), rays/s, launches per step (from the point chunks: a
     backward's dgrad, wgrad and two reductions per chunk, remat's K1
     besides) and peak memory for cuda bf16 stash, cuda bf16 remat, cuda
     f32 remat (the shipped scene configs' step, at their point_chunk
     POINT_CHUNK, with the range of the cotangent reaching each scene MLP:
     max, median |g| and the share below fp16's smallest normal) and torch
     f32, each also at the other point_chunk (0 or POINT_CHUNK); the f32
     remat step must peak below torch f32 at point_chunk 0 (one warm-up
     step before each window); one step's grads through the
     kernels in bf16 and in f32 against the torch f32 backend (cosine of
     each parameter's grad >=
     GRAD_COS_MIN), and the control that the bound rejects: the bf16 path
     fed a stash with one block shifted by a column; after the steps the
     forward kernel, bf16 and f32 (packed before the steps), gives the bits
     of a freshly packed copy of the weights (no stale weight pack), bf16
     within the mean-gap control of its plain version, f32 within its limit;
  7k. pack: the weight packs' kernel (csrc/nerf_mlp_pack.cu, built with
     phase 2's three sources): its blobs bit for bit the torch ops' at
     widths 256 and 128, PE 10/4, 12/4 and 12/8, f32 and bf16, one launch a
     pack; a weight of 5000, nan or inf in a CUDA module raising the torch
     ops' ValueError at that module's next call of the pack; the kernel
     (with its range flag's copy) in device us against the torch ops' host
     ms a call; configs/poster's Trainer for PACK_ITERS iterations from its
     kernel stage under torch.cuda.set_sync_debug_mode("warn"): the syncs by
     site, none inside a pack, PACK_SYNCS `sync.*` spans and 4 pack
     launches an iteration;
  7w. width128: the kernels' width-128 builds, on the fused family's one
     width besides 256 at which the JAX package runs its kernels (the views
     layer padded to 128 lanes), in both dtypes: K1 output only at
     SHAPES_FWD_128 (the flagship's P, the render and eval chunks, ragged,
     one point) as phase 3 holds it, and K1 with its stash, K2 and K3 at
     SHAPES_BWD_128 as phase 4 holds them (stash within STASH_TOL, grads
     within BWD_TOL, bitwise repeat, stash == remat; in f32 equivariance
     at g 2^-20 and both scale units bit for bit; in bf16 the mean-gap
     controls and the wgrad alone within WGRAD_ALONE_TOL; the coarse and
     fine P also at POINT_CHUNK; times against bounds of the width's
     314,880 FLOP a point a pass, the dgrad and wgrad apart, beside the
     wgrad its 12 torch.mm, and by stage); then the steps W128_STEPS at
     netwidth = netwidth_fine = 128, all at POINT_CHUNK: the shipped
     configs' (f32 remat: K1 f32 2, K3 f32 75 launches a step), the
     flagship's bf16 stash and the shipped configs' under
     mlp_compute_dtype = bfloat16 (bf16 remat), each with the launches of
     `step_launches` and no call of a scene MLP's plain forward, and plain
     torch f32: ms a step, peak memory, the f32 step traced; the f32 and
     the bf16 stash step's grads at cosine >= GRAD_COS_MIN against torch
     f32, and the bf16 path fed a stash with a3 shifted by a column (the
     control) rejected; one 400x400 render_image in bf16 at width 128
     against the torch f32 render (80 launches, rgb 1e-2, depth 5e-2, as
     phase 6); last a Trainer from configs/poster at width 128 (W128_ITERS
     iterations from the kernel stage on `synthetic_scene` cut to
     W128_VIEWS views): each
     iteration's launches, a finite loss whose last 4 average below its
     first 4, and one eval view through K1 f32 (2 launches a ray chunk,
     finite PSNR);
  7p. pe: every PE of PE_GEOS (pe_x over two 64-column chunks: 12/4; pe_d
     over two: 4/9, 4/12; padded widths past 128, which the forward packs
     tightly: 12/8, 16/4, 4/16), which the kernels did not run before, in
     both dtypes at widths 256 and 128 at PE_CHECK_P (two or three tiles a
     block of the persistent grids, a ragged tail): K1 output only and with
     its stash, K2 and K3 as phases 3 and 4 hold the shipped PE's (the
     limits of this header, bitwise repeat, stash == remat, in f32
     equivariance at g 2^-20 and K1's scale units); K1, K2 and K3 timed at
     PE_TIMED (width 256, the coarse and fine P) against bounds of the
     PE's own multiply-adds, with K1's PE warps' share of a tile at the
     fine P; then a user's path at PE_PATH: configs/poster through
     `Config.from_args([... "--multires", "12", "--multires_views",
     "8"])` (f32 remat at POINT_CHUNK), a Trainer of PE_TRAINER_ITERS
     iterations on `synthetic_scene` from the kernel stage (K1 f32 2 and
     K3 f32 75 launches each, no call of a scene MLP's plain forward) and
     one eval view, one step's grads at cosine >= GRAD_COS_MIN against
     torch f32, and one 400x400 bf16 render_image (80 K1 launches, rgb
     within PE_RENDER_RGB_TOL of the same render through K1's plain
     version);
  7a. tonemap: the learned tone maps on the shipped step (configs/poster,
     f32 remat at POINT_CHUNK, full width, 1024 rays): under 'learn' one
     kernel step (K1 f32 2, K3 f32 75 launches), plain torch f32's grads
     and the float64 step's (`trainer.float64_copy`) on the same draws;
     each parameter whose torch f32 grad carries a direction (cosine
     against float64 >= GRAD_COS_MIN; the scene MLPs and the tone map's 8
     tensors among them) at GRAD_COS_MIN against torch f32, the RBK's by
     RBK_F64_FACTOR against float64 (as the ddp phase); then one 100x100
     render_image under 'split_linear' against its torch f32 render (rgb
     1e-4, depth 1e-3, as phase 6's f32);
  7b. trainer: the trainer a user runs (lushnerf_torch.train.trainer.Trainer)
     with the shipped configs/poster (f32 remat at point_chunk POINT_CHUNK,
     full width) on a scene of 29 views at 400x400 made in numpy from a
     seed (`synthetic_scene`), written as an LLFF directory of PNGs
     (`write_llff_scene`: images/ with every PNG row filter 0-4, the
     preprocess cache images_preprocess/ with sub rows as OpenCV writes
     it, poses_bounds.npy) and read back through `load_llff_data` (no
     image package) twice, from the cache (read_png's row path) and from
     images/ with preprocess off (its wavefront), the images bit for bit
     the scene's uint8 values each time, the write and both loads' seconds
     printed; the Trainer built on it from `Config.from_file` with that
     datadir (which reads the cache): 60 iterations through naive (1024 rays), kernel and allkernel (5120
     sub-rays), each launching K1/K3 as step_launches reckons for its
     stage's points; the loss finite at every i_print (10) and its mean
     over iterations 51-60 below that of 1-10; eval at 60 (render_factor
     4: 100x100) writing its PNGs with a finite PSNR and SSIM, timed a
     view; LPIPS (random weights from a numpy seed, written by torch.save
     and read by `load_weights`) of 2 test views on the card against the
     CPU within LPIPS_RTOL, and why the real metric is unavailable;
     checkpoints at 30 and 60; a second Trainer resuming from
     000060.ckpt with the model and Adam state bit for bit and 5 more
     steps; render_only's frames (the first 2 of the loader's spiral);
     then the loop's ms per iteration over
     2 allkernel iterations (nothing at a cadence inside) against 2
     bare train_step calls on batches of the same dataset, in turns, the
     ratio below LOOP_OVER_STEP_MAX; the loop's peak device memory with
     the dataset on the card;
  7c. cte: the same Trainer and config cut to 40 iterations (kernel from
     10, allkernel from 20, CTE from 30, rematch_interval 30) with the
     stub matcher injected (certainty 0.9 >= the 0.8 threshold): each
     iteration's launches as step_launches reckons them (a consist
     iteration adds the aligned render of CTE_RAYS rays: K1 on its coarse
     and fine points, K3 on its fine points only, the loss reading the fine
     rgb alone: K1 4, K3 85 in all), the consist weight None before 30, 0 at 30 and 1e-2 after, the
     losses finite; the rematch at 30 renders the 25 train views at the
     eval size and saves match_tables_000030.npz (the stub's certainty
     throughout, the keypoints at the full resolution); a second Trainer
     resumes from 000040.ckpt with those tables bit for bit (its matcher,
     dkm, has no weights: the fallback); the consist batch's host time;
     ms per consist iteration against a plain allkernel one (2 each, in
     turns); peak memory; renders 3 train views for the dkm phase;
  7d. dkm: DKMMatcher at the published DKMv3 widths (70.3 M random
     weights from seed 0) at the production 640x1120: match_many over the
     9 ordered pairs of the 3 views (the first call apart), per-pair match
     on 2 of them within DKM_PAIR_TOL, certainties finite in [0, 1],
     keypoints within the image; ms per encoder pass and per ordered pair
     (pair_batch 2), peak memory, the 625-pair rematch of 25 views
     extrapolated from them; one pair at 64x96 on the card against the
     CPU within DKM_CPU_TOL;
  7e. ddp: data-parallel training (lushnerf_torch.parallel) with the same
     config: a world of 1 (NCCL in this process, 10 iterations) bit for bit
     against no process group; the fixed-batch step of the whole batch in
     this process through the kernels, through plain torch f32 and in
     float64 (`trainer.float64_copy`): each of the 83 parameters' cosine
     and |g - g64| / |g64| for both f32 steps (the worst 5 of each and the
     21 RBK rows printed), each RBK grad's kernel error within
     RBK_F64_FACTOR of torch f32's; then DDP_WORLD rank processes of this script
     (started after the build; NCCL with a card each where the machine has
     DDP_WORLD cards, else gloo, all on card 0): one step of their halves of
     a fixed 1024-ray batch, bitwise across ranks and against this process
     on the whole batch (the cosine of all grads and of each parameter
     whose f32 grad carries a direction, the scene MLPs' always, at least
     GRAD_COS_MIN; rank 0's params Adam's step of its all-reduced grads,
     bit for bit); 10 iterations through Trainer (CTE from 7, a striped
     rematch at 8 with a content-keyed stub, a striped eval and the
     checkpoint at 10), each iteration's K1 / K3 launches as step_launches
     reckons them for 512 rays a rank (K3 in 3 + 5 chunks), tables equal to
     one process's, tables, metrics, losses and params the same on every
     rank, files in rank 0's basedir only; a resume where the other ranks'
     basedirs are empty; ms an iteration of a rank (2 windows of
     DDP_WINDOW) beside the world of 1's, the flat all-reduce's ms, each
     rank's peak memory;
  8. profile: a torch.profiler trace (CUDA activity: the runtime calls and
     the device's work) of forward_kernel, render_image and one train step
     each of cuda bf16 stash, cuda f32 remat (at point_chunk POINT_CHUNK and
     at 0) and torch f32: device time by kernel and the device's busy share;
  9. tune_kernel: the kernel-cost path, `lushnerf_torch.scripts.tune_kernel`
     at P = 983,040 (every time it prints is recorded, with the launches it
     made; its two-length differences of K1, K4 and K5 are the forward's
     time split); then on the script's xd and MLP: the forward kernel (K1)
     against its plain version with phase 3's bf16 limits, and the remat
     backward (K3) on g = 2 out (the script's sum(out^2)) against the plain
     backward with phase 4's bf16 limits and mean-gap control; the PE-only
     kernel (K4) against its plain version at that P, a ragged P, one
     point, a P off its 64-point tiles and points with |x| up to 1e3 (atol
     1e-5, lanes 90:128 exactly 0), and its time with its sines or its
     stores compiled out (`scripts/pe_ablate.py`) beside its byte bound;
     the matmul-only kernel (K5) against its
     plain version with phase 3's bf16 limits and lanes 3:128 exactly 0;
     K5(K4(xd)) against K1's output on the same xd and weights with the
     same limits;
 10. probe_raymajor: the five per-ray probes of
     `lushnerf_torch.scripts.probe_raymajor` at the JAX probe's shapes (any
     failure fails the phase, launches counted); then at the renderer's
     per-ray shapes (5120 rays x 64 and x 128 samples) each kernel against
     its plain version (each call twice bit for bit), and the device times
     of the kernel, its plain version and the one PyTorch call that
     computes the same function (torch.cumsum, Tensor.clone,
     torch.searchsorted, torch.diff): medians over 5 CUDA-event windows of
     back-to-back calls queued behind a device sleep, so that the host's
     launch cost is not in them; K6/K7, K8 and K10 against Tensor.clone of
     the same bytes and the launch floor (Tensor.clone of 16 bytes) over
     RETIME_WINDOWS (7) windows each, taken in turns, with their spread and each kernel's
     median less the clone's ("retime" lines); K6/K7 at CUMSUM_CASES (S not
     a multiple of 4, rays longer than a block's pass, c from 1 to 128 and
     c 3) and K10 at DISTS_CASES (every n % 4) against the plain versions
     and the PyTorch calls, twice bitwise, and their 64-bit index
     arithmetic bitwise the 32-bit one ("cumsum" and "dists" lines); the
     searchsorted kernel also on unsorted rows with ties (exact, timed) and
     on a ragged S and SI; K8 bit for bit on lengths with a tail and on
     one element.
Then a `{"kernels": [...]}` line (thirteen kernels, each with the path that
launched it: main, main (width 128; f32 and bf16 apart), tune_kernel or
probe_raymajor; K1's
and K3's launches in the cte, ddp and pe phases also apart; each MLP
kernel with the PEs of the pe phase it ran at, `new_pe_geometries`) and,
last, the `{"ok": true, ...}` line.
It needs the repository checkout: run alone it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

T_IMPORTED = time.perf_counter()  # the script's seconds are counted from here
H = W = 400
FOCAL = 320.0
N_RAYS = 1024
NUM_IMAGES = 29
RAY_CHUNK = 4096
# the trainer phase's shapes (configs/poster): N_rand, the rays of a naive
# step, and ray_chunk_eval, the rays of an eval or render_only chunk
TRAINER_N_RAND = 1024
TRAINER_RAY_CHUNK_EVAL = 8192
# the cte phase's consist pass: consist_num_pixels (32, every config) in
# each of the scene's 25 train views (NUM_IMAGES less llffhold 8's 4)
CONSIST_PIXELS = 32
CTE_TRAIN_VIEWS = 25
CTE_RAYS = CTE_TRAIN_VIEWS * CONSIST_PIXELS
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32, outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MLP_MACS = 593_408  # per point, unpadded scene MLP (PE excluded), width 256


def mlp_macs(width: int, in_ch: int = 63, d_ch: int = 27) -> int:
    """Multiply-adds a point of the unpadded scene MLP at `width` (PE
    excluded; in_ch / d_ch PE inputs, the shipped 63 / 27 by default; the
    views layer width / 2 wide): MLP_MACS at 256, 157,440 at 128."""
    w = width
    return (in_ch * w + 7 * w * w + (in_ch + w) * w + w + (w + d_ch) * (w // 2)
            + 3 * (w // 2))


KERNEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}
BF16_MEAN_ERR_SHARE = 0.1  # of the plain version's mean f32-vs-bf16 gap
# backward kernels vs nerf_mlp_bwd_plain on the same stash: max |error| of
# each grad tensor over its max |value|.  f32: the sums over P points run in
# another order (per-tile wgmma sums, up to 132 point splits, then the
# splits), of the split's parts (x within ~2^-22 of it);
# bf16: besides, each d_z is rounded to bf16 after a sum in another order,
# so some roundings land on the neighbouring bf16 value (2^-8 relative).
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the bf16 wgrad's weight grads against the plain f32 products dZ^T A of its
# own dz, stash and PE scratch, max |error| of each tile over its max
# |value|: the bf16 products are exact in f32, so only the order of the f32
# sums differs (the tensor core's within a split, then the splits)
WGRAD_ALONE_TOL = 1e-4
# the forward's stash vs the plain version's, max |error| of each block over
# its max |value|.  f32: sums in another order; bf16: such a sum sends some
# values to the neighbouring bf16 value, one step of at most 2^-7 of it
STASH_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
MLP_WIDTH = 256
# train step grads against the torch f32 backend on the same draws, the
# cosine of each parameter's grad: the kernel path in f32 repeats torch's
# function with sums in another order; in bf16 the RBK's composite-weight
# branch moves most, as its grad is built from differences between the
# sub-rays' colours, which the bf16 rounding perturbs by a like amount
GRAD_COS_MIN = {"float32": 0.9999, "bfloat16": 0.9}
SHAPES_BWD = {"coarse": 5120 * 64, "fine": 5120 * 128, "naive_coarse": TRAINER_N_RAND * 64,
              "naive_fine": TRAINER_N_RAND * 128, "consist_coarse": CTE_RAYS * 64,
              "consist_fine": CTE_RAYS * 128, "ragged": 4096 * 64 + 37, "tiny": 1}
# the SHAPES_BWD rows that also run at POINT_CHUNK
CHUNKED_BWD = ("coarse", "naive_fine", "consist_fine")
POINT_CHUNK = 65_536  # the shipped scene configs' point_chunk (configs/*)
# a bias that puts activation columns past fp16's 65504: bias column 0 of
# layers 0, 4 and 7 and of the feature layer (`large_activation_mlp`)
LARGE_BIAS = 1e5
TUNE_P = 983_040  # the kernel-cost script's point count
PE_TOL = 1e-5  # K4 vs its plain version: sinf against torch.sin, the same f32 arguments
# K4's work per point: 84 trig lanes, a sinf with its range reduction
# counted as 40 operations (generous), at the f32 rate
PE_TRIG_OPS = 84 * 40
RAY_SHAPES = {"coarse": (5120, 64), "fine": (5120, 128)}  # the renderer's rays x samples
# excl_cumsum vs its plain version: sums of up to 128 pdf values in [0, 1]
# in another order (a warp's shuffle tree, then a carry)
CUMSUM_TOL = 1e-5
# (T, S, c) run through K6/K7 beside the renderer's shapes: S not a multiple
# of 4 (a ray starts inside a float4), sample_pdf's 62 and 63 bins, rays of
# one pass and of several (S * c > 1024), every class width of the vector
# kernel (c 1, 2, 4, 8, 16, 32, 128) and the general kernel (c 3)
CUMSUM_CASES = [(5, 1, 1), (7, 3, 1), (5, 37, 1), (9, 62, 1), (9, 63, 1), (4, 64, 1), (3, 128, 1),
                (2, 256, 1), (2, 1000, 1), (5, 37, 3), (16, 64, 8), (3, 128, 8), (2, 3000, 1),
                (2, 300, 8), (3, 50, 2), (3, 37, 4), (2, 70, 16), (2, 40, 32), (2, 20, 128)]
# (T, S) through K10: the c = 1 cases above and the probe's; T * S % 4 takes
# 0, 1, 2 and 3
DISTS_CASES = sorted({(T, S) for T, S, c in CUMSUM_CASES if c == 1} | {(16, 64)})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median over `iters` runs of fn, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def window_ms(fn, n: int):
    """Host-clock ms per call over a window of n calls of fn, back to back
    with one synchronize() at the end, as a training loop runs them: (ms
    per call, the last call's result).  The end-to-end metric."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, out


def per_call_ms(fn, n: int) -> dict:
    """A diagnostic beside window_ms: host-clock ms of n more calls, each
    ended by a synchronize(), as their median, min and max."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(times)), "min": min(times), "max": max(times)}


def device_windows(fns, n: int = 50, repeats: int = 5) -> list:
    """Device ms per call of each of fns, one window per function in turn
    for each of `repeats` rounds: n calls queued back to back behind a
    device sleep longer than the host takes to enqueue them, timed with
    CUDA events from the end of the sleep.  For kernels shorter than their
    launch cost on the host.  Returns each function's list of windows."""
    cycles = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        cycles.append(int(max(host_s, 1e-3) * 2 * 2e9))  # twice the host's time at <= 2 GHz
    times = [[] for _ in fns]
    for _ in range(repeats):
        for i, fn in enumerate(fns):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles[i])
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            times[i].append(a.elapsed_time(b) / n)
    return times


def device_ms(fn, n: int = 50, repeats: int = 5) -> float:
    """Device ms per call of fn: the median of device_windows."""
    return float(np.median(device_windows([fn], n, repeats)[0]))


def spread(ms: list) -> dict:
    q = np.percentile(ms, [0, 25, 50, 75, 100])
    return {"median": float(q[2]), "p25": float(q[1]), "p75": float(q[3]), "min": float(q[0]),
            "max": float(q[4]), "windows": len(ms)}


# the launch counters of lushnerf_torch.ops.fused.nerf_mlp, by kernel
COUNTERS = {"nerf_mlp_fwd": "launches", "nerf_mlp_bwd_stash": "launches_bwd_stash",
            "nerf_mlp_bwd_remat": "launches_bwd_remat"}
# ... of lushnerf_torch.ops.fused.pe_mm and .raymajor
PE_MM_COUNTERS = {"pe_only": "launches_pe_only", "mm_only": "launches_mm_only"}
RAYMAJOR_COUNTERS = {"raymajor_excl_cumsum": "launches_excl_cumsum",
                     "raymajor_transpose": "launches_transpose",
                     "raymajor_searchsorted": "launches_searchsorted",
                     "raymajor_masked_dists": "launches_masked_dists"}


def zero_counts(mod, counters=COUNTERS) -> None:
    """Sets a module's launch counters to 0."""
    for attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(mod, counters=COUNTERS) -> dict:
    return {name: getattr(mod, attr) for name, attr in counters.items()}


def bound_ms(P: int, w_bytes: int, bf16: bool, passes: int = 1, point_bytes: int = 48,
             split_passes: int = 0, macs: int = MLP_MACS) -> tuple:
    """The least time for `passes` x 2 x `macs` FLOP per point (the scene
    MLP's at width 256 unless given) and point_bytes per point + w_bytes of
    traffic (each input read once, each output written once).
    `split_passes` of the f32 passes are the f32 forward's split: three
    bf16 products each, at the bf16 tensor rate."""
    flops = 2.0 * macs * P
    nbytes = P * point_bytes + w_bytes
    t_ops = (flops * (passes - split_passes) / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
             + 3 * flops * split_passes / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


class Smoke:
    def __init__(self):
        self.failed = []
        self.results = {}
        self.seconds = {}  # each phase's wall time

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            self.results[name] = fn()
            print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        except Exception:  # a phase failure is reported, the others still run
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name}: FAILED", flush=True)
        self.seconds[name] = time.perf_counter() - t0


def sample_points(P: int, gen: torch.Generator) -> torch.Tensor:
    """Packed [P, 8] points in the NDC cube with unit view directions."""
    xd = torch.zeros((P, 8), device="cuda")
    xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
    d = torch.randn((P, 3), generator=gen, device="cuda")
    xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
    return xd


# naive / eval: the trainer phase's (render_fine is also its eval chunk's
# coarse P); consist: the cte phase's aligned render; ragged: 2049 tiles,
# odd_tiles: 2561 (the bf16 grid's 132 blocks take unequal tile counts);
# tiny: one point
SHAPES_FWD = {"coarse": 5120 * 64, "fine": 5120 * 128, "render_coarse": 4096 * 64,
              "render_fine": 4096 * 128, "naive_coarse": TRAINER_N_RAND * 64,
              "naive_fine": TRAINER_N_RAND * 128, "eval_fine": TRAINER_RAY_CHUNK_EVAL * 128,
              "consist_coarse": CTE_RAYS * 64, "consist_fine": CTE_RAYS * 128,
              "ragged": 4096 * 64 + 37, "odd_tiles": 2561 * 128 - 5, "tiny": 1}
TIMED_FWD = ("coarse", "fine", "render_coarse", "render_fine")


def kernel_phase(fused, NeRFMLP, MLPConfig):
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return fwd_rows(fused, mlp, ("float32", "bfloat16"), SHAPES_FWD, gen)


def fwd_rows(fused, mlp, dtypes, shapes, gen) -> list:
    """K1 output only against its plain version on `mlp` (either width) in
    each dtype at each of `shapes` (TIMED_FWD among them timed), as phase 3
    holds it."""
    timed = TIMED_FWD
    macs = mlp_macs(mlp.cfg.width)
    rows = []
    for dtype in dtypes:
        w_bytes = sum(t.numel() * t.element_size() for t in fused.pack_params(mlp, dtype))
        for label, P in shapes.items():
            xd = sample_points(P, gen)
            got = fused.nerf_mlp_fwd(mlp, xd, dtype)
            want = fused.nerf_mlp_fwd_plain(mlp, xd, dtype)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol = KERNEL_TOL[dtype]
            bound = tol["atol"] + tol["rtol"] * want.abs()
            excess = (err - bound).max().item()
            row = dict(dtype=dtype, width=mlp.cfg.width, shape=label, P=P,
                       max_abs_err=err.max().item(),
                       mean_abs_err=err.mean().item(), tol_share=(err / bound).max().item(),
                       finite=bool(torch.isfinite(got).all()), within_tol=excess <= 0,
                       repeat_bitwise=bool(torch.equal(got, fused.nerf_mlp_fwd(mlp, xd, dtype))))
            if dtype == "bfloat16" and label != "tiny":
                # the control: how far the plain version moves without bf16 rounding
                gap = (fused.nerf_mlp_fwd_plain(mlp, xd, "float32") - want).abs()
                row["plain_f32_vs_bf16_max_gap"] = gap.max().item()
                row["plain_f32_vs_bf16_mean_gap"] = gap.mean().item()
                row["within_tol"] &= (row["mean_abs_err"]
                                      <= BF16_MEAN_ERR_SHARE * row["plain_f32_vs_bf16_mean_gap"])
            if label in timed:
                row["ms"] = time_ms(lambda: fused.nerf_mlp_fwd(mlp, xd, dtype), 5)
                row["plain_ms"] = time_ms(lambda: fused.nerf_mlp_fwd_plain(mlp, xd, dtype), 2, 1)
                row["bound_ms"], row["bound_by"] = bound_ms(P, w_bytes, dtype == "bfloat16",
                                                            split_passes=int(dtype == "float32"),
                                                            macs=macs)
                if dtype == "float32":  # beside it, the same function on the f32 FMAs
                    row["fma_bound_ms"] = bound_ms(P, w_bytes, False, macs=macs)[0]
                row["tflops"] = 2.0 * macs * P / row["ms"] / 1e9
            if dtype == "bfloat16" and label == "fine":
                row["torch_matmul_9_ms"] = torch_matmul_ms(P, gen, mlp.cfg.width)
            print("  " + json.dumps(row), flush=True)
            rows.append(row)
            if not (row["finite"] and row["within_tol"] and row["repeat_bitwise"]):
                raise AssertionError(f"kernel disagrees with plain version: {row}")
    return rows


def flat_grads(res):
    """(d_xd, [grads]) -> [d_xd, *grads]"""
    return [res[0]] + list(res[1])


def held_fwd(out_k, out_p, out_f, dtype) -> dict:
    """The stash launch's raw output against the plain version's, as the
    kernel phase holds it: KERNEL_TOL per value, and in bf16 the mean error
    at most BF16_MEAN_ERR_SHARE of the plain f32-vs-bf16 mean gap (out_f is
    the plain version in f32)."""
    err = (out_k - out_p).abs()
    tol = KERNEL_TOL[dtype]
    r = {"fwd_out_max_abs_err": err.max().item(), "finite": bool(torch.isfinite(out_k).all())}
    ok = (err - tol["atol"] - tol["rtol"] * out_p.abs()).max().item() <= 0
    if out_f is not None:
        r["fwd_out_mean_err_over_f32_gap"] = err.mean().item() / (out_f - out_p).abs().mean().item()
        ok &= r["fwd_out_mean_err_over_f32_gap"] <= BF16_MEAN_ERR_SHARE
    r["fwd_out_within_tol"] = ok
    return r


def held_stash(acts_k, acts_p, acts_f, dtype) -> dict:
    """The kernel's stash against the plain version's, block by block
    (a0..a7, feat, hv): max |error| over the block's max |value| within
    STASH_TOL, and in bf16 the mean |error| at most BF16_MEAN_ERR_SHARE of
    the mean gap between the plain stash in f32 (acts_f) and in bf16, so
    that a store which skipped or truncated the bf16 rounding would fail."""
    w = (acts_k.shape[1] - 128) // 9  # the width of the stash's layout
    blocks = [(l * w, (l + 1) * w) for l in range(9)]
    blocks.append((9 * w, acts_k.shape[1]))
    rel, ratio = [], []
    for b0, b1 in blocks:
        k, p = acts_k[:, b0:b1].float(), acts_p[:, b0:b1].float()
        err = (k - p).abs()
        rel.append((err.max() / p.abs().max().clamp_min(1e-30)).item())
        if acts_f is not None:
            ratio.append((err.mean() / (acts_f[:, b0:b1] - p).abs().mean()).item())
    r = {"stash_max_rel_err": max(rel), "stash_worst_block": int(np.argmax(rel))}
    ok = max(rel) <= STASH_TOL[dtype] and bool(torch.isfinite(acts_k).all())
    if ratio:
        r["stash_mean_err_over_f32_gap_max"] = max(ratio)
        ok &= max(ratio) <= BF16_MEAN_ERR_SHARE
    r["stash_within_tol"] = ok
    return r


def held_bwd(got, want, f32, dtype, prefix) -> dict:
    """A backward's d(xd) and 24 grads against the plain backward's: each
    tensor's max |error| over its max |value| within BWD_TOL, and in bf16
    each tensor's mean |error| at most BF16_MEAN_ERR_SHARE of the mean gap
    to the plain backward in f32 (f32); the rgb and alpha bias grads (sums
    of g alone) have no gap and are held by the max error only."""
    abs_err = [(a - b).abs().max().item() for a, b in zip(got, want)]
    rel_err = [e / max(b.abs().max().item(), 1e-30) for e, b in zip(abs_err, want)]
    r = {f"{prefix}_max_abs_err": max(abs_err), f"{prefix}_max_rel_err": max(rel_err),
         f"{prefix}_worst_tensor": int(np.argmax(rel_err)),
         f"{prefix}_tol_share": max(rel_err) / BWD_TOL[dtype]}
    ok = max(rel_err) <= BWD_TOL[dtype]
    if f32 is not None:
        gaps = [(c - b).abs().mean().item() for b, c in zip(want, f32)]
        ratios = [(a - b).abs().mean().item() / gap for a, b, gap in zip(got, want, gaps) if gap > 0]
        r[f"{prefix}_mean_err_over_f32_gap_max"] = max(ratios)
        r[f"{prefix}_tensors_without_gap"] = sum(gap == 0 for gap in gaps)
        ok &= max(ratios) <= BF16_MEAN_ERR_SHARE
    r[f"{prefix}_within_tol"] = ok
    return r


def dgrad_breakdown(stages, stamps, dgrad_ms, off_path=()) -> dict:
    """The dgrad's time by stage from block 0's stage stamps: each stage's
    share of the stamped cycles over all of block 0's tiles, and that share
    of the dgrad's measured ms; the stages grouped as the tile's load,
    heads, layer matmuls (mm_*), the waits for each layer's mask (wait_*),
    layer epilogues (ep_*), d_pe passes (dpe_*) and d(xd) (dxd_*); beside
    them the off-path columns (the f32 PE warps' cycles by task) as shares
    of the tile's cycles."""
    st = stamps.cpu().numpy().astype(np.float64)
    n = len(stages) + 1
    on, off = st[:, :n], st[:, n:]
    keep = (on > 0).all(1)
    d = np.diff(on[keep], axis=1)
    total = d.sum()
    share = {name: float(d[:, i].sum() / total) for i, name in enumerate(stages)}
    group_of = {"mm": "matmul", "wait": "mask_wait", "ep": "epilogue", "dpe": "dpe_passes"}
    groups = {}
    for name, v in share.items():
        key = group_of.get(name.split("_")[0], name)
        groups[key] = groups.get(key, 0.0) + v
    return {"tiles": int(d.shape[0]), "cycles_per_tile": float(total / d.shape[0]),
            "group_share": groups, "group_ms": {k: v * dgrad_ms for k, v in groups.items()},
            "stage_share": share,
            "off_path_share_of_tile": {name: float(off[keep][:, i].sum() / total)
                                       for i, name in enumerate(off_path)}}


def fwd_breakdown(fused, mlp, xd, ms: float, stash: bool, dtype: str, nf=(10, 4)) -> dict:
    """The forward kernel's time by stage from its instrumented
    instantiation in `dtype`: consumer thread 0's cycles by stage over block 0's
    tiles, each stage's share of them and that share of the kernel's
    measured ms; beside them, the PE warps' work a tile (off that path) as a
    share of the tile's cycles."""
    st = fused.fwd_stage_cycles(mlp, xd, stash, dtype, *nf).cpu().numpy().astype(np.float64)
    n = len(fused.FWD_STAGES)
    on_path, off_path = st[:, :n], st[:, n:]
    total = on_path.sum()
    share = {name: float(on_path[:, i].sum() / total) for i, name in enumerate(fused.FWD_STAGES)}
    return {"tiles": int(st.shape[0]), "cycles_per_tile": float(total / st.shape[0]),
            "stage_share": share, "stage_ms": {k: v * ms for k, v in share.items()},
            "off_path_share_of_tile": {name: float(off_path[:, i].sum() / total)
                                       for i, name in enumerate(fused.FWD_OFF_PATH)}}


def torch_matmul_ms(P: int, gen, width: int = MLP_WIDTH) -> float:
    """A yardstick, not a library column (no one call computes K1): the
    nine W-wide products of K1's layers (K = 64, W x 4, W + 64, W x 3)
    through torch.matmul in bf16 at P points, CUDA-event ms, median of 5."""
    ks = [64] + [width] * 4 + [width + 64] + [width] * 3
    a = {k: torch.randn((P, k), generator=gen, device="cuda").bfloat16() for k in set(ks)}
    w = [torch.randn((k, width), generator=gen, device="cuda").bfloat16() for k in ks]
    return time_ms(lambda: [torch.matmul(a[k], m) for k, m in zip(ks, w)], 5)


# the wgrad's 12 weight blocks dW = dZ^T A: (dz column, rows O, A from the
# PE scratch?, A column, columns I) with kx, kd the padded PE widths, at an
# MLP width W (the views blocks' W / 2 rows, no padding)
def wgrad_jobs(kx: int, kd: int, W: int = MLP_WIDTH) -> list:
    return ([(0, W, True, 0, kx)] + [(l * W, W, False, (l - 1) * W, W) for l in range(1, 5)]
            + [(5 * W, W, True, 0, kx), (5 * W, W, False, 4 * W, W)]
            + [(l * W, W, False, (l - 1) * W, W) for l in range(6, 9)]
            + [(9 * W, W // 2, False, 8 * W, W), (9 * W, W // 2, True, kx, kd)])


def torch_wgrad_mm_ms(run) -> float:
    """A yardstick beside the wgrad, not one library call (none computes it):
    the 12 weight blocks dW = dZ^T A as 12 torch.mm calls on the backward's
    own dz, stash and PE scratch (f32 with TF32 off, or bf16), CUDA-event
    ms of the 12, median of 5."""
    def mm12():
        for zc, o, from_pe, ac, i in wgrad_jobs(run.kx, run.kd, run.width):
            src = run.pe if from_pe else run.acts
            torch.mm(run.dz[:, zc:zc + o].T, src[:, ac:ac + i])
    return time_ms(mm12, 5)


def wgrad_clock_shares(run, wgrad_ms: float) -> dict:
    """A wgrad's block-0 cycles from its instrumented instantiation (labelled
    by run.wgrad_clock_names) as shares of its consumers' total and of its
    loaders' (f32: the converters; bf16: the TMA producer thread), and the
    consumers' shares of the wgrad's measured ms."""
    c = dict(zip(run.wgrad_clock_names, run.wgrad_clocks().cpu().tolist()))
    mm = {k: c[k] / c["mm_all"] for k in ("mm_full_wait", "mm", "mm_epilogue")}
    loader, total = ("converter", "conv_all") if "conv_all" in c else ("producer", "load_all")
    side = {k: v / c[total] for k, v in c.items() if k.startswith(total[:4]) and k != total}
    return {"cycles": c, "consumer_share": mm, f"{loader}_share": side, "loader": loader,
            "loader_cycles": c[total], "consumer_ms": {k: v * wgrad_ms for k, v in mm.items()}}


def wgrad_alone(fused, run) -> dict:
    """The wgrad's weight grads (run.dw after run.run()) against the plain
    f32 products dZ^T A of its own dz, stash and PE scratch, tile by tile
    of fused.wgrad_items: each tile's max |error| over its max |value|,
    within WGRAD_ALONE_TOL."""
    worst = 0.0
    for _, _, rows, I, off, ldw, zc, from_pe, ac in fused.wgrad_items(1, run.kx, run.kd,
                                                                      width=run.width):
        got = torch.as_strided(run.dw, (rows, I), (ldw, 1), off)
        src = run.pe if from_pe else run.acts
        want = run.dz[:, zc:zc + rows].float().T @ src[:, ac:ac + I].float()
        err = (got - want).abs().max() / want.abs().max().clamp_min(1e-30)
        worst = max(worst, err.item())
        del want
    return {"wgrad_alone_max_rel_err": worst, "wgrad_alone_tol_share": worst / WGRAD_ALONE_TOL,
            "wgrad_alone_within_tol": worst <= WGRAD_ALONE_TOL}


def bwd_parts(fused, mlp, xd, g, dtype, acts, units, breakdown: bool) -> dict:
    """The dgrad alone and the wgrad with its reductions alone (on the
    dgrad's scratch), median CUDA-event ms, with their bounds: operations
    (one pass of 2 x MLP_MACS FLOP a point each: in bf16 at the bf16 tensor
    rate; in f32 both as the split, three fp16 products at that rate) and
    bytes (dgrad: this design's, the stash columns it reads, xd, g, and the
    dz, PE and d(xd) it writes; wgrad: dz, the stash columns and the PE
    read once and the weight grads written once, with beside it this
    design's per-split partials written and read once); beside the wgrad a
    yardstick, its 12 blocks through torch.mm; with `breakdown` also the
    dgrad's stage breakdown and the wgrad's cycles in its consumers and its
    converters (f32) or its producer (bf16)."""
    P = xd.shape[0]
    bf16 = dtype == "bfloat16"
    run = fused.BwdLaunch(mlp, xd, g, dtype, 10, 4, acts, units)
    run.run()
    esz = 2 if bf16 else 4
    Wd = run.width
    # the unpadded stash row (at width 128 the kernels' hv has 64 padding lanes)
    stash_b, pe_b = (9 * Wd + Wd // 2) * esz, (run.kx + run.kd) * esz
    read_b = stash_b - Wd * esz  # a0..a7 and hv: not feat
    r = {"dtype": dtype, "P": P, "dgrad_ms": time_ms(lambda: run.run(run.DGRAD), 5),
         "wgrad_ms": time_ms(lambda: run.run(run.WGRAD), 5),
         "wgrad_torch_mm_12_calls_ms": torch_wgrad_mm_ms(run), "wgrad_splits": run.n_splits}
    flops = 2.0 * mlp_macs(Wd) * P
    t_ops_d = flops * (1 if bf16 else 3) / PEAK_BF16_FLOPS * 1e3
    t_ops_w = t_ops_d
    dgrad_bytes = P * (read_b + 48 + stash_b + pe_b + 32)
    wgrad_bytes = P * (stash_b + (stash_b - Wd // 2 * esz) + pe_b) + run.dw.numel() * 4
    r["wgrad_partials_bytes_ms"] = 2 * run.w_part.numel() * 4 / PEAK_BYTES * 1e3
    for part, t_ops, nbytes in (("dgrad", t_ops_d, dgrad_bytes), ("wgrad", t_ops_w, wgrad_bytes)):
        t_bytes = nbytes / PEAK_BYTES * 1e3
        r[f"{part}_bytes_bound_ms"], r[f"{part}_ops_bound_ms"] = t_bytes, t_ops
        r[f"{part}_bound_ms"] = max(t_ops, t_bytes)
        r[f"{part}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  {dtype} dgrad / wgrad apart at P = {P}, width {Wd}: "
          + json.dumps({k: v for k, v in r.items() if k not in ("dtype", "P")}), flush=True)
    if breakdown:
        r["dgrad_stages"] = dgrad_breakdown(run.stages, run.stage_stamps(), r["dgrad_ms"],
                                            () if bf16 else fused.DGRAD_OFF_PATH_F32)
        print(f"  dgrad stages at P = {P} ({dtype}, width {Wd}, {r['dgrad_ms']:.3f} ms, "
              f"{r['dgrad_stages']['cycles_per_tile']:.0f} cycles a tile): "
              + json.dumps(r["dgrad_stages"]["group_share"]) + "; off the path: "
              + json.dumps(r["dgrad_stages"]["off_path_share_of_tile"]), flush=True)
        w = r["wgrad_stages"] = wgrad_clock_shares(run, r["wgrad_ms"])
        print(f"  wgrad stages at P = {P} ({dtype}, width {Wd}, {r['wgrad_ms']:.3f} ms, block 0: "
              f"consumers {w['cycles']['mm_all']} cycles, {w['loader']} {w['loader_cycles']}): "
              f"consumers " + json.dumps(w["consumer_share"]) + f"; {w['loader']} "
              + json.dumps(w[f"{w['loader']}_share"]), flush=True)
    del run
    return r


def zs_bitwise(fused, mlp, xd, g, acts) -> bool:
    """The f32 dgrad's scale units of dz, bit for bit those of
    `fused.dz_scale_units` on the dz it wrote."""
    run = fused.BwdLaunch(mlp, xd, g, "float32", 10, 4, acts)
    run.run(run.DGRAD)
    return torch.equal(run.zs, fused.dz_scale_units(run.dz))


def shipped_cotangent(P: int, gen) -> torch.Tensor:
    """A cotangent [P, 4] shaped like the one reaching a scene MLP in the
    shipped configs' step (phase 7): half the points exactly 0, the rest
    |g| log-uniform over 2^-28 .. 2^-17 with random signs."""
    mag = torch.exp2(torch.rand((P, 4), generator=gen, device="cuda") * 11 - 28)
    sign = torch.where(torch.rand((P, 4), generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    live = torch.rand((P, 1), generator=gen, device="cuda") < 0.5
    return mag * sign * live


def equivariant(fused, mlp, xd, g, dtype, acts, got, k: int = -20, nf=(10, 4)) -> bool:
    """The backward at g 2^k against 2^k times its output at g (`got`), bit
    for bit: every scale inside it is a power of two."""
    small = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g * 2.0 ** k, dtype, *nf, acts=acts))
    torch.cuda.synchronize()
    return all(torch.equal(a * 2.0 ** k, b) for a, b in zip(got, small))


def kernel_bwd_phase(fused, NeRFMLP, MLPConfig):
    """K1 with its stash, K2 and K3 against the plain versions on the same
    inputs (the plain backward reads the kernel's stash), then the times."""
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for dtype in ("float32", "bfloat16"):
        shapes = (SHAPES_BWD if dtype == "bfloat16"
                  else {**SHAPES_BWD, "shipped": SHAPES_BWD["coarse"]})
        rows += bwd_rows(fused, mlp, dtype, shapes, gen)
    row = large_activation_row(fused, mlp, sample_points(SHAPES_BWD["coarse"], gen), gen)
    rows.append(row)
    if not row["ok"]:
        raise AssertionError(f"the f32 kernels disagree at large activations: {row}")
    row = tiny_cotangent_row(fused, mlp, sample_points(SHAPES_BWD["coarse"], gen), gen)
    rows.append(row)
    if not row["ok"]:
        raise AssertionError(f"the f32 backward fails on a tiny cotangent: {row}")
    return rows


def bwd_rows(fused, mlp, dtype, shapes, gen, chunked=CHUNKED_BWD) -> list:
    """Phase 4's rows for `mlp` (either width) in `dtype` at each of
    `shapes`: K1 with its stash, K2 and K3 against the plain versions (the
    `chunked` ones also at POINT_CHUNK), the coarse and fine P timed, the
    fine one by stage; raises on the first row that fails."""
    rows = []
    bf16 = dtype == "bfloat16"
    esz = 2 if bf16 else 4
    Wd = mlp.cfg.width
    macs = mlp_macs(Wd)
    w_bytes = sum(t.numel() * t.element_size() for t in fused.pack_params(mlp, dtype))
    grad_bytes = 4 * sum(p.numel() for p in mlp.parameters())
    stash_b = (9 * Wd + Wd // 2) * esz  # the unpadded stash row
    for label, P in shapes.items():
        xd = sample_points(P, gen)
        g = (shipped_cotangent(P, gen) if label == "shipped"
             else torch.randn((P, 4), generator=gen, device="cuda"))
        out_k, acts_k, units_k = fused._launch_fwd(mlp, xd, dtype, 10, 4, stash=True)
        out_p, acts_p = fused.nerf_mlp_fwd_plain(mlp, xd, dtype, with_acts=True)
        # the control for bf16: the plain version without the bf16 rounding
        # (a mean over one point is no control: not at the tiny P)
        control = bf16 and label != "tiny"
        out_f, acts_f = (fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
                         if control else (None, None))
        row = dict(dtype=dtype, width=Wd, shape=label, P=P,
                   **held_fwd(out_k, out_p, out_f, dtype),
                   **held_stash(acts_k, acts_p, acts_f, dtype))
        del out_f, acts_f
        run = fused.BwdLaunch(mlp, xd, g, dtype, 10, 4, acts_k, units_k)
        run.run()
        k2 = flat_grads(run.result())
        torch.cuda.synchronize()
        if bf16:
            row.update(wgrad_alone(fused, run))
        del run
        k2b = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, acts=acts_k, acts_units=units_k))
        torch.cuda.synchronize()
        k3 = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype))
        torch.cuda.synchronize()
        row.update(repeat_bitwise=all(torch.equal(a, b) for a, b in zip(k2, k2b)),
                   remat_bitwise=all(torch.equal(a, b) for a, b in zip(k2, k3)),
                   finite=row["finite"] and all(bool(torch.isfinite(t).all())
                                                for t in k2 + k3))
        if not row["finite"]:  # which of d(xd) (0) and the 24 grads (1..24)
            row["nonfinite_tensors"] = [i for i, t in enumerate(k2)
                                        if not bool(torch.isfinite(t).all())]
        del k2b, k3
        if not bf16:
            row["equivariant_bitwise"] = equivariant(fused, mlp, xd, g, dtype, acts_k, k2)
            row["zs_bitwise"] = zs_bitwise(fused, mlp, xd, g, acts_k)
            row["units_bitwise"] = torch.equal(units_k, fused.stash_scale_units(acts_k))
        # the control for bf16: the plain backward in f32 (its own activations)
        f32 = flat_grads(fused.nerf_mlp_bwd_plain(mlp, xd, g, "float32")) if control else None
        # K2 against the plain backward on the kernel's stash, and once more
        # on the plain forward's own stash
        want = flat_grads(fused.nerf_mlp_bwd_plain(mlp, xd, g, dtype, acts=acts_k))
        row.update(held_bwd(k2, want, f32, dtype, "bwd"))
        if label in chunked:
            row["chunked"] = chunked_bwd(fused, mlp, xd, g, dtype, acts_k, units_k, k2,
                                         want, f32)
        del want
        k2p = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, acts=acts_p))
        torch.cuda.synchronize()
        row.update(held_bwd(k2p, flat_grads(fused.nerf_mlp_bwd_plain(
            mlp, xd, g, dtype, acts=acts_p)), f32, dtype, "bwd_on_plain_stash"))
        del f32, k2p
        row["within_tol"] = all(v for k, v in row.items() if k.endswith("_within_tol"))
        if label in ("coarse", "fine"):
            row["fwd_stash_ms"] = time_ms(
                lambda: fused._launch_fwd(mlp, xd, dtype, 10, 4, stash=True), 5)
            # the plain versions (tens of ms, no launch cost to speak of):
            # one call after 1
            row["fwd_stash_plain_ms"] = time_ms(
                lambda: fused.nerf_mlp_fwd_plain(mlp, xd, dtype, with_acts=True), 1, 1)
            row["stash_ms"] = time_ms(
                lambda: fused.nerf_mlp_bwd(mlp, xd, g, dtype, acts=acts_k, acts_units=units_k),
                5)
            row["stash_plain_ms"] = time_ms(
                lambda: fused.nerf_mlp_bwd_plain(mlp, xd, g, dtype, acts=acts_k), 1, 1)
            row["remat_ms"] = time_ms(lambda: fused.nerf_mlp_bwd(mlp, xd, g, dtype), 5)
            row["remat_plain_ms"] = time_ms(
                lambda: fused.nerf_mlp_bwd_plain(mlp, xd, g, dtype), 1, 1)
            # the functions' own traffic: xd 32 B, g 16 B, d(xd) 32 B, raw out
            # 16 B per point, the stash, the weights once and the grads once
            # (f32: every pass is the split)
            row["fwd_stash_bound_ms"], row["fwd_stash_bound_by"] = bound_ms(
                P, w_bytes, bf16, 1, 48 + stash_b, split_passes=int(not bf16), macs=macs)
            row["stash_bound_ms"], row["stash_bound_by"] = bound_ms(
                P, w_bytes + grad_bytes, bf16, 2, 80 + stash_b, split_passes=2 * int(not bf16),
                macs=macs)
            row["remat_bound_ms"], row["remat_bound_by"] = bound_ms(
                P, w_bytes + grad_bytes, bf16, 3, 80, split_passes=3 * int(not bf16),
                macs=macs)
            # what this design moves besides: the dz scratch written and read
            # again, the PE scratch, and in remat the activation scratch
            pe_b = 96 * esz
            row["design_scratch_bytes_per_point_stash"] = 2 * stash_b + 2 * pe_b
            row["design_scratch_bytes_per_point_remat"] = 4 * stash_b + 2 * pe_b
            row.update(bwd_parts(fused, mlp, xd, g, dtype, acts_k, units_k, label == "fine"))
            if label == "fine":
                row["fwd_stages"] = {}
                for form, stash in (("output_only", False), ("stash", True)):
                    ms = time_ms(lambda: fused._launch_fwd(mlp, xd, dtype, 10, 4, stash), 5)
                    r = row["fwd_stages"][form] = fwd_breakdown(fused, mlp, xd, ms, stash, dtype)
                    print(f"  fwd stages at P = {P} ({dtype}, width {Wd}, {form}, {ms:.3f} ms, "
                          f"{r['cycles_per_tile']:.0f} cycles a tile): "
                          + json.dumps(r["stage_share"]) + "; off the path: "
                          + json.dumps(r["off_path_share_of_tile"]), flush=True)
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
        del k2, acts_k, acts_p, units_k
        torch.cuda.empty_cache()
        if not (row["finite"] and row["within_tol"] and row["repeat_bitwise"]
                and row["remat_bitwise"] and row.get("equivariant_bitwise", True)
                and row.get("zs_bitwise", True) and row.get("units_bitwise", True)
                and row.get("chunked", {}).get("ok", True)):
            raise AssertionError(f"backward kernels disagree with the plain version: {row}")
    return rows


def tiny_cotangent_row(fused, mlp, xd, gen) -> dict:
    """K2 and K3 f32 (in one chunk and at POINT_CHUNK) at the coarse P on a
    cotangent far below the shipped one: half the points 0, the rest |g|
    log-uniform over 2^-149 (f32's least denormal) .. 2^-60 with random
    signs, where a d_z row's scale would pass 2^100 (the f32 dgrad keeps
    it there): every value finite, d(xd) and the 24 grads within BWD_TOL of
    the plain backward in f64 on the kernel's stash, K3 the bits of K2, the
    dgrad's scale units of dz those of `dz_scale_units`.  (A trainer's
    coarse MLP met such a cotangent, max |g| 5.8e-20, and its grads came
    back NaN.)"""
    P = xd.shape[0]
    mag = torch.exp2(torch.rand((P, 4), generator=gen, device="cuda") * 89 - 149)
    sign = torch.where(torch.rand((P, 4), generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    g = mag * sign * (torch.rand((P, 1), generator=gen, device="cuda") < 0.5)
    _, acts_k, units_k = fused._launch_fwd(mlp, xd, "float32", 10, 4, stash=True)
    k2 = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, "float32", acts=acts_k, acts_units=units_k))
    k3 = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, "float32"))
    k3c = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, "float32", point_chunk=POINT_CHUNK))
    torch.cuda.synchronize()
    m64 = copy.deepcopy(mlp).double()
    want64 = flat_grads(fused.nerf_mlp_bwd_plain(m64, xd.double(), g.double(), "float32",
                                                 acts=acts_k.double()))
    r = {"shape": "tiny_cotangent", "dtype": "float32", "P": P,
         "g_max": g.abs().max().item(), "g_denormal_share": ((g != 0) & (g.abs() < 2.0 ** -126))
         .float().mean().item(),
         **held_bwd(k2, want64, None, "float32", "bwd"),
         **{f"chunked_{k}": v for k, v in held_bwd(k3c, want64, None, "float32", "bwd").items()},
         "remat_bitwise": all(torch.equal(a, b) for a, b in zip(k2, k3)),
         "zs_bitwise": zs_bitwise(fused, mlp, xd, g, acts_k)}
    r["finite"] = all(bool(torch.isfinite(t).all()) for t in k2 + k3 + k3c)
    r["ok"] = (r["finite"] and r["bwd_within_tol"] and r["chunked_bwd_within_tol"]
               and r["remat_bitwise"] and r["zs_bitwise"])
    print("  " + json.dumps(r), flush=True)
    del acts_k, k2, k3, k3c, want64, m64
    torch.cuda.empty_cache()
    return r


def chunked_bwd(fused, mlp, xd, g, dtype, acts, units, k2, want, f32) -> dict:
    """K2 and K3 at point_chunk POINT_CHUNK (their scratch one chunk in
    size, each chunk's grads added to the chunks' before) against K2 in one
    chunk (k2): each tensor's max |error| over its max |value| within
    BWD_TOL (the weight and bias grads' sums run in another order; d(xd)
    is per point, so its bits); against the plain backward (want, with the
    bf16 control f32) as `held_bwd` holds K2; a second run gives the same
    bits; stash and remat agree to the bit."""
    n_chunks = len(fused.point_chunks(xd.shape[0], POINT_CHUNK))
    c2 = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, acts=acts, acts_units=units,
                                       point_chunk=POINT_CHUNK))
    c2b = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, acts=acts, acts_units=units,
                                        point_chunk=POINT_CHUNK))
    c3 = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, point_chunk=POINT_CHUNK))
    torch.cuda.synchronize()
    rel = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(c2, k2)]
    r = {"point_chunk": POINT_CHUNK, "chunks": n_chunks, "max_rel_err_vs_one_chunk": max(rel),
         "tol_share": max(rel) / BWD_TOL[dtype],
         "dxd_bitwise_vs_one_chunk": torch.equal(c2[0], k2[0]),
         "repeat_bitwise": all(torch.equal(a, b) for a, b in zip(c2, c2b)),
         "remat_bitwise": all(torch.equal(a, b) for a, b in zip(c2, c3)),
         "finite": all(bool(torch.isfinite(t).all()) for t in c2 + c3),
         **held_bwd(c2, want, f32, dtype, "vs_plain")}
    r["ok"] = (n_chunks > 1 and max(rel) <= BWD_TOL[dtype] and r["repeat_bitwise"]
               and r["remat_bitwise"] and r["finite"] and r["vs_plain_within_tol"])
    print(f"  {dtype} chunked backward at P = {xd.shape[0]}: " + json.dumps(r), flush=True)
    return r


def large_activation_mlp(NeRFMLP, MLPConfig):
    """The phase's MLP with bias column 0 of layers 0, 4 and 7 and of the
    feature layer at LARGE_BIAS: a0, a4, a7 and feat hold a column past
    fp16's 65504 on every point, every weight stays as it was."""
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    with torch.no_grad():
        for lin in (mlp.pts_linears[0], mlp.pts_linears[4], mlp.pts_linears[7],
                    mlp.feature_linear):
            lin.bias[0] = LARGE_BIAS
    return mlp.cuda().requires_grad_(False)


def large_activation_row(fused, mlp, xd, gen) -> dict:
    """K1 f32 (output only and with its stash), K2 and K3 f32 at the coarse
    P on `large_activation_mlp`: every value finite, the output within
    KERNEL_TOL and the stash within STASH_TOL of the plain f32 forward, d(xd)
    and the 24 grads within BWD_TOL of the plain backward on the kernel's
    stash, K3 the bits of K2, the stash's scale units those of
    `stash_scale_units`.  The plain backward runs in f64 here, and the
    cotangent is |N(0, 1)|: with random signs the grads sum 327,680 terms of
    up to 1e5 that cancel to a few parts in 1e4 of their size, which f32
    sums in any order (the plain f32 backward's too) miss BWD_TOL of; that
    case's errors against f64, the kernel's and the plain f32 backward's,
    are printed beside as a diagnostic."""
    big = large_activation_mlp(type(mlp), type(mlp.cfg))
    P = xd.shape[0]
    g_signed = torch.randn((P, 4), generator=gen, device="cuda")
    g = g_signed.abs()
    out = fused.nerf_mlp_fwd(big, xd, "float32")
    out_k, acts_k, units_k = fused._launch_fwd(big, xd, "float32", 10, 4, stash=True)
    out_p, acts_p = fused.nerf_mlp_fwd_plain(big, xd, "float32", with_acts=True)
    k2 = flat_grads(fused.nerf_mlp_bwd(big, xd, g, "float32", acts=acts_k, acts_units=units_k))
    k3 = flat_grads(fused.nerf_mlp_bwd(big, xd, g, "float32"))
    torch.cuda.synchronize()
    big64 = copy.deepcopy(big).double()

    def plain64(cot):
        return flat_grads(fused.nerf_mlp_bwd_plain(big64, xd.double(), cot.double(), "float32",
                                                   acts=acts_k.double()))

    def rel_errs(got, want):
        return max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))

    want64 = plain64(g)
    s64 = plain64(g_signed)
    signed = {"kernel": rel_errs(flat_grads(fused.nerf_mlp_bwd(
        big, xd, g_signed, "float32", acts=acts_k, acts_units=units_k)), s64),
        "plain_f32": rel_errs(flat_grads(fused.nerf_mlp_bwd_plain(
            big, xd, g_signed, "float32", acts=acts_k)), s64)}
    del s64
    r = {"shape": "large_activation", "dtype": "float32", "P": P,
         "largest_activation": acts_p.abs().max().item(),
         "rows_scaled_share": (units_k > 1).float().mean().item(),
         **held_fwd(out, out_p, None, "float32"),
         **{f"stash_launch_{k}": v for k, v in held_fwd(out_k, out_p, None, "float32").items()},
         **held_stash(acts_k, acts_p, None, "float32"),
         **held_bwd(k2, want64, None, "float32", "bwd"),
         "diag_signed_cotangent_max_rel_err_vs_f64": signed,
         "remat_bitwise": all(torch.equal(a, b) for a, b in zip(k2, k3)),
         "units_bitwise": torch.equal(units_k, fused.stash_scale_units(acts_k))}
    r["finite"] = all(bool(torch.isfinite(t).all()) for t in [out, out_k, acts_k] + k2 + k3)
    r["ok"] = (r["largest_activation"] >= 65520 and r["finite"] and r["fwd_out_within_tol"]
               and r["stash_launch_fwd_out_within_tol"] and r["stash_within_tol"]
               and r["bwd_within_tol"] and r["remat_bitwise"] and r["units_bitwise"])
    print("  " + json.dumps(r), flush=True)
    del big, big64, acts_k, acts_p, k2, k3, want64
    torch.cuda.empty_cache()
    return r


def flagship(cfg_mod, backend=None, dtype=None):
    lc = cfg_mod.flagship_cfg(num_images=NUM_IMAGES).lush_config()
    if backend is not None:
        lc = dataclasses.replace(
            lc, render=dataclasses.replace(lc.render, mlp_backend=backend, mlp_compute_dtype=dtype)
        )
    return lc


def train_batch():
    """The flagship step's batch, drawn as bench.py draws it (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    rays_o = (0.1 * rng.standard_normal((N_RAYS, 3))).astype(np.float32)
    rays_d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5
    batch = {
        "rays": np.stack([rays_o, rays_d], axis=-1),
        "rgbs": rng.random((N_RAYS, 3), dtype=np.float32),
        "images_idx": rng.integers(0, NUM_IMAGES, N_RAYS, dtype=np.int32),
        "fq_mask": rng.integers(0, 2, N_RAYS).astype(bool),
    }
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def flagship_batch():
    """(rays, image indices) of the train batch, for the forwards."""
    batch = train_batch()
    return batch["rays"], batch["images_idx"]


def max_err(a, b):
    return (a - b).abs().max().item()


def forward_phase(fused, lush, cfg_mod):
    lc = flagship(cfg_mod)
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    rays, idx = flagship_batch()
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    with torch.no_grad():
        # the same draws through the kernel (bf16, f32) and plain torch (f32)
        rnd = lush._train_randomness(gen, lc, N_RAYS * lc.rbk.num_rays_out, rays.device)
        outs = {
            name: lush.forward_kernel(
                model, flagship(cfg_mod, be, dt), H, W, FOCAL, rays, idx, None,
                rand_override=rnd,
            )
            for name, be, dt in (("bf16", "cuda", "bfloat16"), ("f32", "cuda", "float32"),
                                 ("torch", "torch", "float32"))
        }
        for key in ("rgb_blur", "rgb0_blur", "depth", "acc"):
            res[f"{key}_err_f32_vs_torch"] = max_err(outs["f32"][key], outs["torch"][key])
            res[f"{key}_err_bf16_vs_torch"] = max_err(outs["bf16"][key], outs["torch"][key])
        def call():
            return lush.forward_kernel(model, lc, H, W, FOCAL, rays, idx, gen)

        call()  # warm-up
        n_calls = 10
        zero_counts(fused)
        res["ms_per_call"], out = window_ms(call, n_calls)
        res["launches"] = read_counts(fused)["nerf_mlp_fwd"]
        res["per_call_ms"] = per_call_ms(call, 5)
        tcfg = flagship(cfg_mod, "torch", "float32")
        res["torch_f32_ms_per_call"] = window_ms(
            lambda: lush.forward_kernel(model, tcfg, H, W, FOCAL, rays, idx, gen), 5)[0]
    res["calls"] = n_calls
    res["rays_per_s"] = N_RAYS / res["ms_per_call"] * 1e3
    res["finite"] = all(bool(torch.isfinite(v).all()) for v in out.values())
    res["rgb_blur_shape"] = list(out["rgb_blur"].shape)
    print("  " + json.dumps(res), flush=True)
    assert res["launches"] == 2 * n_calls, f"expected {2 * n_calls} launches"
    assert res["finite"] and res["rgb_blur_shape"] == [N_RAYS, 3]
    for key in ("rgb_blur", "rgb0_blur", "acc"):
        assert res[f"{key}_err_f32_vs_torch"] < 1e-4, key
        assert res[f"{key}_err_bf16_vs_torch"] < 1e-2, key
    assert res["depth_err_f32_vs_torch"] < 1e-3 and res["depth_err_bf16_vs_torch"] < 5e-2
    return res


def render_phase(fused, lush, cfg_mod):
    lc = flagship(cfg_mod)
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    res = {}
    lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)  # warm-up
    torch.cuda.synchronize()
    zero_counts(fused)
    t0 = time.perf_counter()
    rgb, noise, depth = lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)
    torch.cuda.synchronize()
    res["ms_per_image"] = (time.perf_counter() - t0) * 1e3
    res["launches"] = read_counts(fused)["nerf_mlp_fwd"]
    t0 = time.perf_counter()
    ref = lush.render_image(model, flagship(cfg_mod, "torch", "float32"), H, W, K, c2w,
                            RAY_CHUNK)
    torch.cuda.synchronize()
    res["torch_f32_ms_per_image"] = (time.perf_counter() - t0) * 1e3
    f32_lc = flagship(cfg_mod, "cuda", "float32")
    lush.render_image(model, f32_lc, H, W, K, c2w, RAY_CHUNK)  # warm-up (the f32 packs)
    torch.cuda.synchronize()
    zero_counts(fused)
    t0 = time.perf_counter()
    f32 = lush.render_image(model, f32_lc, H, W, K, c2w, RAY_CHUNK)
    torch.cuda.synchronize()
    res["f32_ms_per_image"] = (time.perf_counter() - t0) * 1e3
    res["f32_launches"] = read_counts(fused)["nerf_mlp_fwd"]
    for i, key in enumerate(("rgb", "noise", "depth")):
        res[f"{key}_err_bf16_vs_torch"] = max_err((rgb, noise, depth)[i], ref[i])
        res[f"{key}_err_f32_vs_torch"] = max_err(f32[i], ref[i])
    res["finite"] = all(bool(torch.isfinite(t).all()) for t in (rgb, noise, depth))
    res["shape"] = list(rgb.shape)
    print("  " + json.dumps(res), flush=True)
    assert res["launches"] == 80 and res["f32_launches"] == 80, \
        "expected 80 launches (40 chunks x coarse + fine)"
    assert res["finite"] and res["shape"] == [H, W, 3]
    assert res["rgb_err_f32_vs_torch"] < 1e-4 and res["rgb_err_bf16_vs_torch"] < 1e-2
    assert res["depth_err_f32_vs_torch"] < 1e-3 and res["depth_err_bf16_vs_torch"] < 5e-2
    return res


# the flagship's step (bf16 stash), bf16 remat, the shipped scene configs'
# step (f32 remat: mlp_backend = pallas, the dtype and backward left at
# their defaults) and plain torch, each with its point_chunk: the
# flagship's 0, the shipped configs' POINT_CHUNK (each is measured at the
# other too)
TRAIN_VARIANTS = {"stash": ("cuda", "bfloat16", "stash"), "remat": ("cuda", "bfloat16", "remat"),
                  "remat_f32": ("cuda", "float32", "remat"), "torch": ("torch", "float32", "remat")}
GRAD_VARIANTS = dict(TRAIN_VARIANTS, stash_f32=("cuda", "float32", "stash"))
VARIANT_CHUNK = {"remat_f32": POINT_CHUNK}  # the others run the flagship's 0
STEP_POINTS = (N_RAYS * 5 * 64, N_RAYS * 5 * 128)  # the coarse and fine MLPs' points a step


def step_launches(fused, variant: str, point_chunk: int, points=STEP_POINTS,
                  bwd_points=None) -> dict:
    """Kernel launches per flagship train step (the scene MLPs' evaluations
    at `points`: the coarse and fine MLPs' point counts, and with the CTE
    pass its coarse and fine ones): one forward each; a backward, for those
    whose output the loss reads (`bwd_points`, all of `points` when None;
    the CTE pass reads only its fine MLP's), runs for each of its point
    chunks (`point_chunks`) the dgrad, the wgrad and two reductions (remat:
    first K1 writing the chunk's stash)."""
    be, _, bwd = TRAIN_VARIANTS[variant]
    if be == "torch":
        return {"nerf_mlp_fwd": 0, "nerf_mlp_bwd_stash": 0, "nerf_mlp_bwd_remat": 0}
    per_chunk = 5 if bwd == "remat" else 4
    n = sum(per_chunk * len(fused.point_chunks(P, point_chunk))
            for P in (points if bwd_points is None else bwd_points))
    return {"nerf_mlp_fwd": len(points), "nerf_mlp_bwd_stash": n * (bwd == "stash"),
            "nerf_mlp_bwd_remat": n * (bwd == "remat")}
STEP_PACKS = 4  # forward and backward blobs of both scene MLPs, once per step


@contextlib.contextmanager
def corrupted_stash(fused, on: bool, block: int = 3):
    """While on, the forward kernel's stash has block `block` (a3) shifted
    by one column, as a wrong column offset in its store would write it:
    the control for GRAD_COS_MIN."""
    launch = fused._launch_fwd

    def shifted(*args, **kwargs):
        out, acts, units = launch(*args, **kwargs)
        if acts is not None:
            w = fused.width_of_ld(acts.shape[1])
            cols = acts[:, block * w:(block + 1) * w]
            cols.copy_(cols.roll(1, dims=1))
        return out, acts, units

    if on:
        fused._launch_fwd = shifted
    try:
        yield
    finally:
        fused._launch_fwd = launch


@contextlib.contextmanager
def cotangent_ranges(fused, out: list):
    """While on, each backward kernel call records the range of the
    cotangent reaching its scene MLP: P, max |g|, median |g|, the share of
    exact zeros and the median of the other |g|, and the share of |g|
    below fp16's smallest normal (2^-14)."""
    bwd = fused.nerf_mlp_bwd

    def recorded(mlp, xd, g, *args, **kwargs):
        a = g.abs()
        nz = a[a > 0]
        out.append({"P": g.shape[0], "max_abs_g": a.max().item(), "median_abs_g": a.median().item(),
                    "share_zero": 1.0 - nz.numel() / a.numel(),
                    "median_abs_nonzero_g": nz.median().item() if nz.numel() else 0.0,
                    "share_below_fp16_normal": (a < 2.0 ** -14).float().mean().item()})
        return bwd(mlp, xd, g, *args, **kwargs)

    fused.nerf_mlp_bwd = recorded
    try:
        yield
    finally:
        fused.nerf_mlp_bwd = bwd


def train_cfg(cfg_mod, variant, point_chunk=None):
    """The flagship config under a variant's backend, dtype, backward and
    point_chunk (None: the variant's own, VARIANT_CHUNK or 0)."""
    cfg = cfg_mod.flagship_cfg(num_images=NUM_IMAGES)
    be, dt, bwd = GRAD_VARIANTS[variant]
    cfg.mlp_backend, cfg.mlp_compute_dtype, cfg.mlp_bwd = be, dt, bwd
    cfg.point_chunk = VARIANT_CHUNK.get(variant, 0) if point_chunk is None else point_chunk
    return cfg, cfg.lush_config()


def train_phase(fused, lush, cfg_mod, trainer):
    from lushnerf_torch.utils import trace

    batch = train_batch()
    res = {"launches_total": {k: 0 for k in COUNTERS}}

    def count():
        """The counts since they were set to 0, added to the phase's totals."""
        counts = read_counts(fused)
        for k, v in counts.items():
            res["launches_total"][k] += v
        return counts

    def fresh(variant, point_chunk=None):
        cfg, lc = train_cfg(cfg_mod, variant, point_chunk)
        model = lush.LushNeRF(lc, seed=0, device="cuda")
        opt, sched = trainer.make_optimizer(cfg, model)
        return cfg, lc, model, opt, sched

    # 1. one step in each stage, flagship config (stash), launches counted
    cfg, lc, model, opt, sched = fresh("stash")
    assert cfg.lrate == 5e-4 and lc.render.mlp_bwd == "stash"
    gen = torch.Generator(device="cuda").manual_seed(1)
    for stage in ("kernel", "allkernel", "naive"):
        zero_counts(fused)
        since = time.perf_counter_ns()
        with trace.recording():
            loss, mse = trainer.train_step(model, opt, sched, lc, H, W, FOCAL, batch, stage, gen)
            torch.cuda.synchronize()
        packs = sum(r.name == "mlp.pack" for r in trace.spans(since))
        r = dict(loss=loss.item(), mse=mse.item(), launches=count(), packs=packs)
        res[f"stage_{stage}"] = r
        print(f"  {stage}: " + json.dumps(r), flush=True)
        assert np.isfinite(r["loss"]), stage
        assert r["launches"] == step_launches(fused, "stash", 0), (stage, r["launches"])
        assert packs == STEP_PACKS, (stage, packs)
    del model, opt, sched

    # 2. twenty kernel steps on a fixed batch and fixed draws: the loss falls
    cfg, lc, model, opt, sched = fresh("stash")
    rnd = lush._train_randomness(torch.Generator(device="cuda").manual_seed(3), lc,
                                 N_RAYS * lc.rbk.num_rays_out, torch.device("cuda"))
    xd = sample_points(4096 * 16, torch.Generator(device="cuda").manual_seed(4))
    with torch.no_grad():  # the f32 pack of the weights before the steps
        fused.nerf_mlp_fwd(model.mlp_fine, xd, "float32")
    zero_counts(fused)
    losses = [trainer.train_step(model, opt, sched, lc, H, W, FOCAL, batch, "kernel",
                                 rand_override=rnd)[0] for _ in range(20)]
    losses = [v.item() for v in losses]
    count()
    res["fixed_batch_losses"] = losses
    print("  fixed batch losses: " + json.dumps(losses), flush=True)
    assert all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5]) \
        and losses[-1] < losses[0], "the loss did not fall"
    # the weights changed in place 20 times: the kernel must see the new ones,
    # bit for bit as a fresh module holding them (its own packs) gives, and
    # stay within the bf16 mean-gap control of the plain version.  Its
    # per-value limit is phase 3's, on fresh weights: on these trained ones
    # a few values sit near it, and a backward that sums in another order
    # moves them across it (0.0021 and 0.0024 for two such backwards).  The
    # f32 kernel (packed before the steps) the same, and within KERNEL_TOL.
    mlp = model.mlp_fine
    with torch.no_grad():
        got = fused.nerf_mlp_fwd(mlp, xd, "bfloat16")
        repacked = type(mlp)(mlp.cfg, torch.Generator().manual_seed(0), torch.device("cpu")).cuda()
        repacked.load_state_dict(mlp.state_dict())
        again = fused.nerf_mlp_fwd(repacked, xd, "bfloat16")
        want = fused.nerf_mlp_fwd_plain(mlp, xd, "bfloat16")
        want_f32 = fused.nerf_mlp_fwd_plain(mlp, xd, "float32")
        gap = (want_f32 - want).abs().mean().item()
        got_f32 = fused.nerf_mlp_fwd(mlp, xd, "float32")
        again_f32 = fused.nerf_mlp_fwd(repacked, xd, "float32")
    res["after_steps_fwd_bitwise_vs_fresh_pack"] = bool(torch.equal(got, again))
    res["after_steps_fwd_max_abs_err"] = (got - want).abs().max().item()
    res["after_steps_fwd_mean_err_over_f32_gap"] = (got - want).abs().mean().item() / gap
    res["after_steps_fwd_f32_bitwise_vs_fresh_pack"] = bool(torch.equal(got_f32, again_f32))
    res["after_steps_fwd_f32_max_abs_err"] = (got_f32 - want_f32).abs().max().item()
    tol = KERNEL_TOL["float32"]
    share = ((got_f32 - want_f32).abs() / (tol["atol"] + tol["rtol"] * want_f32.abs())).max().item()
    res["after_steps_fwd_f32_tol_share"] = share
    f32_ok = share <= 1
    assert (res["after_steps_fwd_bitwise_vs_fresh_pack"] and bool(torch.isfinite(got).all())
            and res["after_steps_fwd_mean_err_over_f32_gap"] <= BF16_MEAN_ERR_SHARE
            and res["after_steps_fwd_f32_bitwise_vs_fresh_pack"] and f32_ok), \
        f"forward after training steps disagrees: {res}"
    del repacked
    del model, opt, sched
    torch.cuda.empty_cache()

    # 3. ms/step, rays/s and peak memory of the three backends, each at its
    # own point_chunk (res[variant]) and at the other (res[variant@chunk])
    for variant, chunk in [(v, c) for v in TRAIN_VARIANTS
                           for c in sorted({VARIANT_CHUNK.get(v, 0), 0, POINT_CHUNK},
                                           key=lambda c: c != VARIANT_CHUNK.get(v, 0))]:
        own = chunk == VARIANT_CHUNK.get(variant, 0)
        cfg, lc, model, opt, sched = fresh(variant, chunk)
        assert lc.render.point_chunk == chunk
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            return trainer.train_step(model, opt, sched, lc, H, W, FOCAL, batch, "kernel", gen)

        step()  # the warm-up: the weight packs, the allocator's pools
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fused)
        n = 2
        ms, (loss, _) = window_ms(step, n)
        counts = count()
        r = dict(point_chunk=chunk, ms_per_step=ms, rays_per_s=N_RAYS / ms * 1e3, steps=n,
                 per_step_ms=per_call_ms(step, 2),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches_per_step={k: v / n for k, v in counts.items()}, loss=loss.item())
        if variant == "remat_f32" and own:  # one more step: what reaches the scene MLPs' backward
            ranges = r["cotangent_ranges"] = []
            with cotangent_ranges(fused, ranges):
                step()
            print("  cotangent reaching each scene MLP (shipped configs' step): "
                  + json.dumps(ranges), flush=True)
            assert len(ranges) == 2 and all(np.isfinite(x["max_abs_g"]) for x in ranges), ranges
        key = variant if own else f"{variant}@{chunk}"
        res[key] = r
        print(f"  {key}: " + json.dumps(r), flush=True)
        assert r["launches_per_step"] == step_launches(fused, variant, chunk), key
        assert np.isfinite(r["loss"])
        del model, opt, sched
        torch.cuda.empty_cache()
    res["peak_mem_gb"] = {k: v["peak_mem_gb"] for k, v in res.items()
                          if isinstance(v, dict) and "peak_mem_gb" in v}
    print("  peak memory (GB) by variant and point_chunk: " + json.dumps(res["peak_mem_gb"]),
          flush=True)
    # the shipped configs' step must need less memory than plain torch f32
    # does at the flagship's setting, the mode's purpose
    assert res["remat_f32"]["peak_mem_gb"] < res["torch"]["peak_mem_gb"], res["peak_mem_gb"]

    # 4. one step's grads, the kernel path (bf16 and f32) vs torch f32, same
    # draws; and the control: the bf16 kernel path fed a stash with one block
    # shifted by a column, which the bound must reject
    grads = {}
    for variant in ("stash", "stash_f32", "torch", "stash_corrupt"):
        cfg, lc, model, opt, sched = fresh(variant.replace("_corrupt", ""))
        with corrupted_stash(fused, variant.endswith("_corrupt")):
            loss, _ = trainer.loss_fn(model, lc, H, W, FOCAL, batch, "kernel", rand_override=rnd)
            loss.backward()  # a comparison: its launches are not counted
        grads[variant] = grads_of(model)
        del model, opt, sched, loss
    for variant, dtype in (("stash", "bfloat16"), ("stash_f32", "float32"),
                           ("stash_corrupt", "bfloat16")):
        cos = grad_cosines(grads[variant], grads["torch"])
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
        flat_k = torch.cat([grads[variant][n].flatten() for n in cos])
        flat_t = torch.cat([grads["torch"][n].flatten() for n in cos])
        tag = variant if variant == "stash_corrupt" else dtype
        res[f"grad_cos_min_{tag}"] = worst[0][1]
        res[f"grad_cos_worst_{tag}"] = worst
        res[f"grad_cos_all_params_{tag}"] = (
            torch.sum(flat_k * flat_t) / (flat_k.norm() * flat_t.norm())).item()
        print(f"  grad cosines vs torch f32, {variant} ({dtype}), worst 5 of {len(cos)}: "
              + json.dumps(worst) + f"; all parameters as one vector: "
              f"{res[f'grad_cos_all_params_{tag}']}", flush=True)
        if variant == "stash_corrupt":
            assert worst[0][1] < GRAD_COS_MIN[dtype], ("the control passed the bound", worst)
        else:
            assert worst[0][1] >= GRAD_COS_MIN[dtype], (dtype, worst)
    del grads
    torch.cuda.empty_cache()
    return res


# the width-128 phase: the shipped scene config (configs/poster: f32, remat,
# POINT_CHUNK) at netwidth = netwidth_fine = 128, the one width besides 256
# that the JAX package's kernels run
W128 = 128
SHAPES_FWD_128 = {k: SHAPES_FWD[k] for k in ("coarse", "fine", "render_coarse", "render_fine",
                                             "eval_fine", "ragged", "tiny")}
SHAPES_BWD_128 = {k: SHAPES_BWD[k] for k in ("coarse", "fine", "ragged", "tiny")}
CHUNKED_BWD_128 = ("coarse", "fine")
W128_ITERS = 8  # Trainer iterations, kernel from 1, allkernel from 5
W128_VIEWS = 9  # the Trainer's scene: llffhold 8 holds out views 0 and 8
W128_TRAINER_OVERRIDES = dict(N_iters=W128_ITERS, kernel_start_iter=1, allkernel_start_iter=5,
                              noisenerf_start_iter=10**9, i_print=4, i_weights=10**9,
                              i_testset=10**9, render_factor=4,
                              netwidth=W128, netwidth_fine=W128)


PACK_GEOS = [(w, pe) for w in (256, W128) for pe in ((10, 4), (12, 4), (12, 8))]
PACK_START = 1200  # the pack phase's Trainer from configs/poster's kernel_start_iter
PACK_ITERS = 20  # its iterations under the sync debug mode
PACK_VIEWS = 9
PACK_SYNCS = 2  # the syncs left an iteration: cumprod's backward, coarse and fine


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def pack_phase(fused, cfg_mod, trainer, NeRFMLP, MLPConfig):
    """The weight packs on the card: csrc/nerf_mlp_pack.cu's blobs bit for
    bit the torch ops' at every geometry the kernels run, one launch a
    pack; an out-of-range weight raising at the module's next pack call;
    the kernel timed against the torch pack; and configs/poster's Trainer
    under torch.cuda.set_sync_debug_mode("warn"): only cumprod's syncs,
    none inside a pack, and 4 pack launches an iteration."""
    from lushnerf_torch.utils import trace

    res = {"blobs": {}}
    gen = torch.Generator(device="cuda").manual_seed(23)

    def cuda_mlp(width=256, pe=(10, 4)):
        cfg = MLPConfig(width=width, input_ch=3 + 6 * pe[0], input_ch_views=3 + 6 * pe[1])
        return NeRFMLP(cfg, gen, torch.device("cuda"))

    # 1. every geometry in both dtypes: the kernel's blobs against the torch ops'
    for width, pe in PACK_GEOS:
        for dtype in ("float32", "bfloat16"):
            mlp = cuda_mlp(width, pe)
            before = fused.launches_pack
            got, got_bwd = fused.pack_params(mlp, dtype), fused.pack_params_bwd(mlp, dtype)
            launched = fused.launches_pack - before
            want, want_bwd = fused._pack_fwd(mlp, dtype), fused._pack_bwd(mlp, dtype)
            ok = all(same_bits(a, b) for a, b in zip((*got, got_bwd), (*want, want_bwd)))
            res["blobs"][f"w{width}_pe{pe[0]}_{pe[1]}_{dtype}"] = ok
            assert ok and launched == 2, (width, pe, dtype, ok, launched)
    print(f"  blobs bitwise the torch ops' at {len(res['blobs'])} geometries and dtypes, "
          f"one launch a pack", flush=True)

    # 2. an out-of-range weight: the module's next call of that pack raises
    for forward, who in ((True, "pack_params"), (False, "pack_params_bwd")):
        pack = fused.pack_params if forward else fused.pack_params_bwd
        for value in (5000.0, float("nan"), float("inf")):
            mlp = cuda_mlp()
            pack(mlp, "float32")
            with torch.no_grad():
                mlp.pts_linears[3].weight[7, 9] = value
            pack(mlp, "float32")  # packs the weight; its flag is read by the next call
            try:
                pack(mlp, "float32")
                raised = ""
            except ValueError as e:
                raised = str(e)
            try:
                fused._pack_fwd(mlp, "float32") if forward else fused._pack_bwd(mlp, "float32")
                want = ""
            except ValueError as e:
                want = str(e)  # the torch ops' message
            res[f"raised_{who}_{value}"] = raised
            assert raised and raised == want, (who, value, raised, want)
    print(f"  an out-of-range weight (5000, nan, inf) raises at the next call: "
          f"{res['raised_pack_params_5000.0']!r}", flush=True)

    # 3. the kernel against the torch ops, the shipped MLP (f32, and bf16,
    # which sends no range flag: the kernel alone)
    mlp = cuda_mlp()
    for forward, name in ((True, "fwd"), (False, "bwd")):
        for dtype in ("float32", "bfloat16"):
            res[f"kernel_us_{name}_{dtype}"] = 1e3 * device_ms(
                lambda: fused._pack_cuda(mlp, dtype, forward=forward))
        res[f"torch_ms_{name}"] = per_call_ms(
            (lambda: fused._pack_fwd(mlp, "float32")) if forward
            else (lambda: fused._pack_bwd(mlp, "float32")), 10)["median"]
    print("  packs of the shipped MLP, forward / backward: f32 kernel + flag copy "
          f"{res['kernel_us_fwd_float32']:.2f} / {res['kernel_us_bwd_float32']:.2f} us on the "
          f"device, bf16 kernel {res['kernel_us_fwd_bfloat16']:.2f} / "
          f"{res['kernel_us_bwd_bfloat16']:.2f} us; f32 torch ops {res['torch_ms_fwd']:.3f} / "
          f"{res['torch_ms_bwd']:.3f} ms a call", flush=True)
    del mlp

    # 4. configs/poster's Trainer at the kernel stage: the syncs of PACK_ITERS
    # iterations by where they were made, after one warm-up iteration
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_pack_")
    try:
        cfg = cfg_mod.Config.from_file(TRAINER_CONFIG, basedir=f"{tmp.name}/logs",
                                       tbdir=f"{tmp.name}/tb", i_testset=10**9, i_weights=10**9)
        assert cfg.kernel_start_iter == PACK_START and cfg.i_print == 200, cfg
        tr = trainer.Trainer(cfg, data=synthetic_scene(n=PACK_VIEWS), device="cuda")
        tr.setup()
        tr.step = PACK_START
        tr.train(PACK_START + 1)
        torch.cuda.synchronize()
        syncs = []

        def record(message, category, filename, lineno, file=None, line=None):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if "lushnerf_torch" in f.filename]
            syncs.append({"message": str(message)[:80], "ours": bool(ours),
                          "in_pack": any(f.name in ("pack_params", "pack_params_bwd")
                                         for f in stack),
                          "site": f"{Path(ours[-1].filename).name}:{ours[-1].lineno} "
                                  f"{ours[-1].name}" if ours else f"{filename}:{lineno}"})

        before = fused.launches_pack
        since = time.perf_counter_ns()
        with warnings.catch_warnings(), trace.recording():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                tr.train(PACK_START + 1 + PACK_ITERS)
                torch.cuda.synchronize()
                res["ms_per_iteration"] = (time.perf_counter() - t0) * 1e3 / PACK_ITERS
            finally:
                torch.cuda.set_sync_debug_mode(0)
        spans = trace.spans(since)
        res["launches_pack_per_iteration"] = (fused.launches_pack - before) / PACK_ITERS
        res["sync_spans_per_iteration"] = sum(r.name.startswith("sync.") for r in spans) / PACK_ITERS
        res["pack_spans_per_iteration"] = sum(r.name == "mlp.pack" for r in spans) / PACK_ITERS
        # the program's syncs (the mode may add a notice of its own)
        sync_warnings = [s for s in syncs if s["ours"] and "synchroniz" in s["message"]]
        res["sync_warnings"] = len(sync_warnings)
        res["sync_sites"] = {}
        for s in sync_warnings:
            res["sync_sites"][s["site"]] = res["sync_sites"].get(s["site"], 0) + 1
        res["sync_warnings_in_pack"] = sum(s["in_pack"] for s in syncs)
        print(f"  {PACK_ITERS} Trainer iterations (configs/poster, from {PACK_START + 1}): "
              + json.dumps({k: res[k] for k in (
                  "ms_per_iteration", "launches_pack_per_iteration", "pack_spans_per_iteration",
                  "sync_spans_per_iteration", "sync_warnings", "sync_warnings_in_pack",
                  "sync_sites")}), flush=True)
        assert res["launches_pack_per_iteration"] == STEP_PACKS, res
        assert res["sync_warnings_in_pack"] == 0, syncs
        assert res["sync_warnings"] <= PACK_SYNCS * PACK_ITERS, syncs
        assert res["sync_spans_per_iteration"] == PACK_SYNCS, res
    finally:
        tmp.cleanup()
    return res


@contextlib.contextmanager
def plain_scene_mlp_calls(NeRFMLP, model, out: list):
    """While on, counts in out[0] the calls of the plain torch forward of
    the model's two scene MLPs (the renderer's path for an MLP the fused
    path does not take)."""
    forward = NeRFMLP.forward
    scene = {id(model.mlp_coarse), id(model.mlp_fine)}

    def counted(self, *args, **kwargs):
        out[0] += id(self) in scene
        return forward(self, *args, **kwargs)

    NeRFMLP.forward = counted
    try:
        yield
    finally:
        NeRFMLP.forward = forward


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


def grad_cosines(got: dict, want: dict) -> dict:
    """Each parameter's grad cosine, `got` against `want` ({name: grad},
    the same parameters)."""
    assert set(got) == set(want), (sorted(set(want) ^ set(got)))
    return {n: (torch.sum(g * want[n]) / (g.norm() * want[n].norm()).clamp_min(1e-30)).item()
            for n, g in got.items()}


def width128_render(fused, lush, cfg_mod) -> dict:
    """One 400x400 render_image of the flagship config (bf16 under the
    'cuda' backend) at width 128, its chunks through K1 bf16's width-128
    build, against the same render through mlp_backend='torch' in f32, as
    phase 6 holds width 256's: 80 launches, finite, rgb within 1e-2 and
    depth within 5e-2."""
    cfg = cfg_mod.flagship_cfg(num_images=NUM_IMAGES)
    cfg.netwidth = cfg.netwidth_fine = W128
    lc = cfg.lush_config()
    assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype) == ("cuda", "bfloat16"), lc.render
    tlc = dataclasses.replace(lc, render=dataclasses.replace(lc.render, mlp_backend="torch",
                                                             mlp_compute_dtype="float32"))
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)  # warm-up (the packs)
    torch.cuda.synchronize()
    zero_counts(fused)
    t0 = time.perf_counter()
    got = lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)
    torch.cuda.synchronize()
    res = {"ms_per_image": (time.perf_counter() - t0) * 1e3, "launches": read_counts(fused)}
    t0 = time.perf_counter()
    ref = lush.render_image(model, tlc, H, W, K, c2w, RAY_CHUNK)
    torch.cuda.synchronize()
    res["torch_f32_ms_per_image"] = (time.perf_counter() - t0) * 1e3
    for i, key in enumerate(("rgb", "noise", "depth")):
        res[f"{key}_err_bf16_vs_torch"] = max_err(got[i], ref[i])
    res["finite"] = all(bool(torch.isfinite(t).all()) for t in got)
    res["shape"] = list(got[0].shape)
    print("  width 128 render_image, bf16: " + json.dumps(res), flush=True)
    assert res["launches"] == {"nerf_mlp_fwd": 80, "nerf_mlp_bwd_stash": 0,
                               "nerf_mlp_bwd_remat": 0}, res["launches"]
    assert res["finite"] and res["shape"] == [H, W, 3]
    assert res["rgb_err_bf16_vs_torch"] < 1e-2 and res["depth_err_bf16_vs_torch"] < 5e-2, res
    return res


# the width-128 phase's steps: the shipped configs' (f32 remat), the
# flagship's (bf16 stash), the shipped configs' under mlp_compute_dtype =
# bfloat16 (bf16 remat) and plain torch f32, all at POINT_CHUNK
W128_STEPS = ("remat_f32", "stash", "remat", "torch")


def width128_phase(fused, lush, cfg_mod, trainer, NeRFMLP, MLPConfig, results):
    """The width-128 kernels (K1, the dgrad, the wgrad; K3 from them) in
    both dtypes against their plain versions as phases 3 and 4 hold width
    256's; the steps of W128_STEPS (launches, no plain scene MLP, ms, peak
    memory; the f32 one traced), the f32 and bf16 stash steps' grads
    against torch f32 with the shifted-stash control; a bf16 render
    (`width128_render`); a Trainer run from the kernel stage and one eval
    view.  The main path's launches are counted by dtype."""
    res = {"launches": {d: {k: 0 for k in COUNTERS} for d in ("float32", "bfloat16")},
           "seconds": {}}
    t_part = [time.perf_counter()]

    def count(counts, dtype):
        for k, v in counts.items():
            res["launches"][dtype][k] += v
        return counts

    def part_done(name):
        now = time.perf_counter()
        res["seconds"][name] = now - t_part[0]
        t_part[0] = now

    # 1. the kernels at width 128, against their plain versions
    mlp = NeRFMLP(MLPConfig(width=W128), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    res["kernel"] = fwd_rows(fused, mlp, ("float32", "bfloat16"), SHAPES_FWD_128, gen)
    part_done("kernel")
    res["kernel_bwd"] = [r for dtype in ("float32", "bfloat16")
                         for r in bwd_rows(fused, mlp, dtype, SHAPES_BWD_128, gen, CHUNKED_BWD_128)]
    del mlp
    torch.cuda.empty_cache()
    part_done("kernel_bwd")

    # 2. the steps at width 128: the kernels, and plain torch f32 as a user
    # at width 128 ran it before (at the config's point_chunk)
    def cfg128(variant):
        cfg, _ = train_cfg(cfg_mod, variant, POINT_CHUNK)
        cfg.netwidth = cfg.netwidth_fine = W128
        return cfg, cfg.lush_config()

    batch = train_batch()
    step_res, models = {}, {}
    for variant in W128_STEPS:
        cfg, lc = cfg128(variant)
        model = lush.LushNeRF(lc, seed=0, device="cuda")
        opt, sched = trainer.make_optimizer(cfg, model)
        step_gen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            return trainer.train_step(model, opt, sched, lc, H, W, FOCAL, batch, "kernel",
                                      step_gen)

        step()  # the warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fused)
        plain = [0]
        n = 2
        with plain_scene_mlp_calls(NeRFMLP, model, plain):
            ms, (loss, _) = window_ms(step, n)
        counts = count(read_counts(fused), lc.render.mlp_compute_dtype)
        r = dict(dtype=lc.render.mlp_compute_dtype, bwd=lc.render.mlp_bwd,
                 point_chunk=lc.render.point_chunk, ms_per_step=ms, steps=n,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches_per_step={k: v / n for k, v in counts.items()},
                 plain_scene_mlp_calls=plain[0], loss=loss.item())
        if variant == "remat_f32":
            r["traced"] = device_trace(step)
        step_res[variant] = r
        print(f"  width 128 step, {variant}: " + json.dumps(r), flush=True)
        assert np.isfinite(r["loss"]), variant
        if variant != "torch":
            assert r["launches_per_step"] == step_launches(fused, variant, POINT_CHUNK), r
            assert r["plain_scene_mlp_calls"] == 0, r
        else:
            assert all(v == 0 for v in r["launches_per_step"].values()) \
                and r["plain_scene_mlp_calls"] > 0, r
        if variant in ("remat_f32", "stash", "torch"):
            models[variant] = lc
        del model, opt, sched
    assert step_res["remat_f32"]["launches_per_step"]["nerf_mlp_fwd"] == 2 \
        and step_res["remat_f32"]["launches_per_step"]["nerf_mlp_bwd_remat"] == 75, step_res
    res["step"] = step_res
    w256 = (results.get("train_step") or {}).get("remat_f32") or {}
    res["step_width256"] = {k: w256.get(k) for k in ("ms_per_step", "peak_mem_gb")}
    # one step's grads, the kernels (f32 remat, bf16 stash, and the bf16
    # stash with its a3 block shifted by a column, the control) against
    # torch f32, on the same draws (a comparison: its launches are not
    # counted)
    rnd = lush._train_randomness(torch.Generator(device="cuda").manual_seed(3), models["torch"],
                                 N_RAYS * models["torch"].rbk.num_rays_out, torch.device("cuda"))
    grads = {}
    for variant in ("remat_f32", "stash", "torch", "stash_corrupt"):
        lc = models[variant.replace("_corrupt", "")]
        model = lush.LushNeRF(lc, seed=0, device="cuda")
        with corrupted_stash(fused, variant.endswith("_corrupt")):
            loss, _ = trainer.loss_fn(model, lc, H, W, FOCAL, batch, "kernel", rand_override=rnd)
            loss.backward()
        grads[variant] = grads_of(model)
        del model, loss
    res["grad_cos"] = {}
    for variant, dtype in (("remat_f32", "float32"), ("stash", "bfloat16"),
                           ("stash_corrupt", "bfloat16")):
        cos = grad_cosines(grads[variant], grads["torch"])
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
        res["grad_cos"][variant] = {"min": worst[0][1], "worst": worst, "params": len(cos)}
        print(f"  width 128 grad cosines vs torch f32, {variant} ({dtype}), worst 5 of "
              f"{len(cos)}: " + json.dumps(worst), flush=True)
        if variant == "stash_corrupt":
            assert worst[0][1] < GRAD_COS_MIN[dtype], ("the control passed the bound", worst)
        else:
            assert worst[0][1] >= GRAD_COS_MIN[dtype], (variant, worst)
    del models, grads
    torch.cuda.empty_cache()
    part_done("step")
    res["render_bf16"] = width128_render(fused, lush, cfg_mod)
    count(res["render_bf16"]["launches"], "bfloat16")
    part_done("render")

    # 3. the Trainer from the kernel stage, then one eval view through K1 f32
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_w128_")
    try:
        cfg = cfg_mod.Config.from_file(TRAINER_CONFIG, basedir=f"{tmp.name}/logs",
                                       tbdir=f"{tmp.name}/tb", **W128_TRAINER_OVERRIDES)
        lc = cfg.lush_config()
        assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype, lc.render.mlp_bwd,
                lc.render.point_chunk, lc.mlp_cfg.width, lc.mlp_cfg_fine.width) == (
            "cuda", "float32", "remat", POINT_CHUNK, W128, W128), lc
        tr = trainer.Trainer(cfg, data=synthetic_scene(n=W128_VIEWS), device="cuda")
        tr.setup()
        steps = []
        real_step = trainer.train_step

        def counted_step(*args, **kwargs):
            before = read_counts(fused)
            loss, mse = real_step(*args, **kwargs)
            steps.append((loss, {k: v - before[k] for k, v in read_counts(fused).items()}))
            return loss, mse

        zero_counts(fused)
        trainer.train_step = counted_step
        try:
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            res["trainer_s"] = time.perf_counter() - t0
        finally:
            trainer.train_step = real_step
        count(read_counts(fused), "float32")
        expect = step_launches(fused, "remat_f32", POINT_CHUNK,
                               (cfg.N_rand * 5 * 64, cfg.N_rand * 5 * 128))
        assert len(steps) == W128_ITERS and all(c == expect for _, c in steps), \
            [c for _, c in steps][:3]
        losses = [loss.item() for loss, _ in steps]
        res["trainer_losses"] = losses
        assert all(np.isfinite(losses)) and np.mean(losses[-4:]) < np.mean(losses[:4]), losses
        view = int(tr.i_test[0])
        zero_counts(fused)
        with torch.no_grad():
            rgb = tr.render_pose(tr.poses[view])[0]
        torch.cuda.synchronize()
        eval_counts = count(read_counts(fused), "float32")
        from lushnerf_torch.utils.metrics import compute_img_metric
        gt = tr._gt_at_eval_res([view])
        res["eval_view"] = dict(view=view, hw=list(rgb.shape[:2]), launches=eval_counts,
                                psnr=compute_img_metric(rgb[None], gt, "psnr"))
        n_chunks = -(-tr.H_eval * tr.W_eval // cfg.ray_chunk_eval)
        assert eval_counts == {"nerf_mlp_fwd": 2 * n_chunks, "nerf_mlp_bwd_stash": 0,
                               "nerf_mlp_bwd_remat": 0}, eval_counts
        assert np.isfinite(res["eval_view"]["psnr"]), res["eval_view"]
    finally:
        tmp.cleanup()
    part_done("trainer")
    print(f"  width 128 Trainer: {W128_ITERS} iterations in {res['trainer_s']:.2f} s, losses "
          + json.dumps(losses) + "; eval view " + json.dumps(res["eval_view"]), flush=True)
    print("  width 128 launches on its main path, by dtype: " + json.dumps(res["launches"])
          + "; seconds by part: " + json.dumps({k: round(v, 1) for k, v in res["seconds"].items()}),
          flush=True)
    return res



# the pe phase: every PE the JAX kernels run that the port's kernels did
# not before (pe_x over two 64-column chunks; pe_d over two;
# padded widths past 128, packed tightly in the forward), by (multires,
# multires_views)
PE_GEOS = {"12/4": (12, 4), "4/9": (4, 9), "4/12": (4, 12), "12/8": (12, 8), "16/4": (16, 4),
           "4/16": (4, 16)}
PE_TIMED = ("12/4", "12/8")  # timed at width 256 at SHAPES_BWD's coarse and fine P
# the checks' P: two or three tiles a block of the persistent grids (the
# forward's PE slot refilled across tiles), a ragged last tile
PE_CHECK_P = 2 * 132 * 128 + 3 * 128 + 37
PE_PATH = "12/8"  # the phase's main path: configs/poster with --multires 12 --multires_views 8
PE_TRAINER_ITERS = 4  # kernel from 1, allkernel from 3
PE_TRAINER_VIEWS = 9
PE_RENDER_RGB_TOL = 1e-3  # the bf16 render against the same render through the plain forward
WIDE_PE_CSRC = "nerf_mlp_dgrad_wide.cu"  # the dgrads for a PE part of 128 channels


def nf_of(cfg) -> tuple:
    """(num_freqs_x, num_freqs_d) of an MLP config's PE inputs."""
    return (cfg.input_ch - 3) // 6, (cfg.input_ch_views - 3) // 6


def pe_check_row(fused, mlp, dtype, xd, g) -> dict:
    """K1 (output only and with its stash), K2 and K3 at the MLP's PE
    against their plain versions, as phases 3 and 4 hold the shipped PE's:
    KERNEL_TOL and STASH_TOL (bf16: the mean-gap controls), BWD_TOL, a
    second K1 and K2 bit for bit, K3 the bits of K2; in f32 the backward at
    g 2^-20 bit for bit 2^-20 times the one at g and K1's scale units those
    of `stash_scale_units`."""
    nf = nf_of(mlp.cfg)
    bf16 = dtype == "bfloat16"
    out = fused.nerf_mlp_fwd(mlp, xd, dtype, *nf)
    out_k, acts_k, units_k = fused._launch_fwd(mlp, xd, dtype, *nf, stash=True)
    out_p, acts_p = fused.nerf_mlp_fwd_plain(mlp, xd, dtype, *nf, with_acts=True)
    out_f, acts_f = (fused.nerf_mlp_fwd_plain(mlp, xd, "float32", *nf, with_acts=True)
                     if bf16 else (None, None))
    row = dict(dtype=dtype, width=mlp.cfg.width, pe=f"{nf[0]}/{nf[1]}", P=xd.shape[0],
               geometry=fused.pe_geometry(mlp.cfg)._asdict(),
               **held_fwd(out, out_p, out_f, dtype), **held_stash(acts_k, acts_p, acts_f, dtype))
    row["fwd_repeat_bitwise"] = bool(torch.equal(out, fused.nerf_mlp_fwd(mlp, xd, dtype, *nf))
                                     and torch.equal(out, out_k))
    del acts_f
    k2 = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, *nf, acts=acts_k, acts_units=units_k))
    k2b = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, *nf, acts=acts_k, acts_units=units_k))
    k3 = flat_grads(fused.nerf_mlp_bwd(mlp, xd, g, dtype, *nf))
    f32 = flat_grads(fused.nerf_mlp_bwd_plain(mlp, xd, g, "float32", *nf)) if bf16 else None
    want = flat_grads(fused.nerf_mlp_bwd_plain(mlp, xd, g, dtype, *nf, acts=acts_k))
    torch.cuda.synchronize()
    row.update(held_bwd(k2, want, f32, dtype, "bwd"),
               repeat_bitwise=all(torch.equal(a, b) for a, b in zip(k2, k2b)),
               remat_bitwise=all(torch.equal(a, b) for a, b in zip(k2, k3)))
    row["finite"] &= all(bool(torch.isfinite(t).all()) for t in k2 + k3)
    if not bf16:
        row["equivariant_bitwise"] = equivariant(fused, mlp, xd, g, dtype, acts_k, k2, nf=nf)
        row["units_bitwise"] = torch.equal(units_k, fused.stash_scale_units(acts_k))
    row["ok"] = (row["finite"] and row["fwd_out_within_tol"] and row["stash_within_tol"]
                 and row["bwd_within_tol"] and row["fwd_repeat_bitwise"] and row["repeat_bitwise"]
                 and row["remat_bitwise"] and row.get("equivariant_bitwise", True)
                 and row.get("units_bitwise", True))
    return row


def pe_timed_row(fused, mlp, dtype, P, gen, breakdown: bool) -> dict:
    """K1 (output only, with its stash), K2 and K3 at the MLP's PE at P
    points: median CUDA-event ms of 3 calls after 2 (the plain versions,
    tens of ms, 1 after 1), with the bounds of this PE's multiply-adds
    (`mlp_macs` at its input widths) and its unpadded stash row; K1's output
    against its plain version; with `breakdown` K1's stages (the PE warps'
    share of a tile among them) output only."""
    nf = nf_of(mlp.cfg)
    bf16 = dtype == "bfloat16"
    W = mlp.cfg.width
    macs = mlp_macs(W, mlp.cfg.input_ch, mlp.cfg.input_ch_views)
    w_bytes = sum(t.numel() * t.element_size() for t in fused.pack_params(mlp, dtype))
    grad_bytes = 4 * sum(p.numel() for p in mlp.parameters())
    stash_b = (9 * W + W // 2) * (2 if bf16 else 4)
    xd = sample_points(P, gen)
    g = torch.randn((P, 4), generator=gen, device="cuda")
    _, acts, units = fused._launch_fwd(mlp, xd, dtype, *nf, stash=True)
    split = 0 if bf16 else 1
    r = dict(dtype=dtype, width=W, pe=f"{nf[0]}/{nf[1]}", P=P,
             fwd_ms=time_ms(lambda: fused.nerf_mlp_fwd(mlp, xd, dtype, *nf), 3),
             fwd_stash_ms=time_ms(lambda: fused._launch_fwd(mlp, xd, dtype, *nf, stash=True), 3),
             stash_ms=time_ms(lambda: fused.nerf_mlp_bwd(mlp, xd, g, dtype, *nf, acts=acts,
                                                         acts_units=units), 3),
             remat_ms=time_ms(lambda: fused.nerf_mlp_bwd(mlp, xd, g, dtype, *nf), 3))
    for key, passes, point_b, extra in (("fwd", 1, 48, 0), ("fwd_stash", 1, 48 + stash_b, 0),
                                        ("stash", 2, 80 + stash_b, grad_bytes),
                                        ("remat", 3, 80, grad_bytes)):
        r[f"{key}_bound_ms"], r[f"{key}_bound_by"] = bound_ms(
            P, w_bytes + extra, bf16, passes, point_b, split_passes=split * passes, macs=macs)
    if P == SHAPES_BWD["fine"]:
        want = fused.nerf_mlp_fwd_plain(mlp, xd, dtype, *nf)
        got = fused.nerf_mlp_fwd(mlp, xd, dtype, *nf)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[dtype]
        r["fwd_tol_share"] = ((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
                              ).max().item()
        r["fwd_max_abs_err"] = (got - want).abs().max().item()
        r["fwd_plain_ms"] = time_ms(lambda: fused.nerf_mlp_fwd_plain(mlp, xd, dtype, *nf), 1, 1)
        r["remat_plain_ms"] = time_ms(
            lambda: fused.nerf_mlp_bwd_plain(mlp, xd, g, dtype, *nf), 1, 1)
        del want, got
        assert r["fwd_tol_share"] <= 1, r
    if breakdown:
        b = fwd_breakdown(fused, mlp, xd, r["fwd_ms"], False, dtype, nf)
        r["fwd_stage_share"] = b["stage_share"]
        r["fwd_pe_work_share_of_tile"] = b["off_path_share_of_tile"]["pe_work"]
    del acts, units, xd, g
    torch.cuda.empty_cache()
    return r


def pe_render(fused, lush, cfg_mod) -> dict:
    """One 400x400 render_image of the flagship config (bf16 under the
    'cuda' backend) at PE_PATH's PE, its chunks through K1 bf16, against
    the same render through K1's plain version: 80 launches, finite, rgb
    within PE_RENDER_RGB_TOL."""
    cfg = cfg_mod.flagship_cfg(num_images=NUM_IMAGES)
    cfg.multires, cfg.multires_views = PE_GEOS[PE_PATH]
    lc = cfg.lush_config()
    assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype) == ("cuda", "bfloat16"), lc.render
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    zero_counts(fused)
    got = lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)
    torch.cuda.synchronize()
    res = {"launches": read_counts(fused)}
    kernel = fused.nerf_mlp_fwd
    fused.nerf_mlp_fwd = lambda mlp, xd, *args: fused.nerf_mlp_fwd_plain(mlp, xd, *args)
    try:
        ref = lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)
    finally:
        fused.nerf_mlp_fwd = kernel
    torch.cuda.synchronize()
    for i, key in enumerate(("rgb", "noise", "depth")):
        res[f"{key}_err_vs_plain"] = max_err(got[i], ref[i])
    res["finite"] = all(bool(torch.isfinite(t).all()) for t in got)
    print(f"  pe render_image at {PE_PATH}, bf16: " + json.dumps(res), flush=True)
    assert res["launches"] == {"nerf_mlp_fwd": 80, "nerf_mlp_bwd_stash": 0,
                               "nerf_mlp_bwd_remat": 0}, res["launches"]
    assert res["finite"] and res["rgb_err_vs_plain"] <= PE_RENDER_RGB_TOL, res
    return res


def pe_phase(fused, lush, cfg_mod, trainer, NeRFMLP, MLPConfig):
    """Every PE of PE_GEOS through the kernels in both dtypes at widths 256
    and 128 (`pe_check_row` at PE_CHECK_P); K1, K2 and K3 timed at PE_TIMED
    (`pe_timed_row`); then the main path at PE_PATH: the poster config
    through `Config.from_args`, a Trainer of PE_TRAINER_ITERS iterations
    (launches as `step_launches` reckons them, no plain scene MLP) and one
    eval view, one step's grads against torch f32, and a bf16 render
    (`pe_render`).  The path's launches are counted."""
    res = {"checks": [], "timed": [], "launches": {k: 0 for k in COUNTERS}, "seconds": {}}
    t_part = [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        res["seconds"][name] = now - t_part[0]
        t_part[0] = now

    def count(counts):
        for k, v in counts.items():
            res["launches"][k] += v
        return counts

    # 1. the kernels at each PE against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(7)
    for width in (256, W128):
        for geo, (nfx, nfd) in PE_GEOS.items():
            cfg = MLPConfig(width=width, input_ch=3 + 6 * nfx, input_ch_views=3 + 6 * nfd)
            mlp = NeRFMLP(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
            mlp = mlp.cuda().requires_grad_(False)
            xd = sample_points(PE_CHECK_P, gen)
            g = torch.randn((PE_CHECK_P, 4), generator=gen, device="cuda")
            for dtype in ("float32", "bfloat16"):
                row = pe_check_row(fused, mlp, dtype, xd, g)
                res["checks"].append(row)
                print("  pe check: " + json.dumps(row), flush=True)
                if not row["ok"]:
                    raise AssertionError(f"the kernels disagree at PE {geo}: {row}")
            del mlp
    part_done("checks")

    # 2. the times at PE_TIMED, width 256
    for geo in PE_TIMED:
        nfx, nfd = PE_GEOS[geo]
        cfg = MLPConfig(input_ch=3 + 6 * nfx, input_ch_views=3 + 6 * nfd)
        mlp = NeRFMLP(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
        mlp = mlp.cuda().requires_grad_(False)
        for dtype in ("float32", "bfloat16"):
            for label in ("coarse", "fine"):
                r = pe_timed_row(fused, mlp, dtype, SHAPES_BWD[label], gen, label == "fine")
                res["timed"].append(r)
                print("  pe timed: " + json.dumps(r), flush=True)
        del mlp
    torch.cuda.empty_cache()
    part_done("timed")

    # 3. the main path: the poster config at PE_PATH, as a user runs it
    nfx, nfd = PE_GEOS[PE_PATH]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_pe_")
    try:
        argv = ["--config", str(TRAINER_CONFIG), "--multires", str(nfx), "--multires_views",
                str(nfd), "--basedir", f"{tmp.name}/logs", "--tbdir", f"{tmp.name}/tb"]
        for k, v in dict(N_iters=PE_TRAINER_ITERS, kernel_start_iter=1, allkernel_start_iter=3,
                         noisenerf_start_iter=10**9, i_print=2, i_weights=10**9, i_testset=10**9,
                         render_factor=4).items():
            argv += [f"--{k}", str(v)]
        cfg = cfg_mod.Config.from_args(argv)
        lc = cfg.lush_config()
        assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype, lc.render.mlp_bwd,
                lc.render.point_chunk, lc.render.multires, lc.render.multires_views,
                lc.mlp_cfg.width, lc.mlp_cfg_fine.width) == (
            "cuda", "float32", "remat", POINT_CHUNK, nfx, nfd, 256, 256), lc
        assert fused.kernel_covers(lc.mlp_cfg, lc.render) \
            and fused.kernel_covers(lc.mlp_cfg_fine, lc.render)
        tr = trainer.Trainer(cfg, data=synthetic_scene(n=PE_TRAINER_VIEWS), device="cuda")
        tr.setup()
        steps, plain = [], [0]
        real_step = trainer.train_step

        def counted_step(*args, **kwargs):
            before = read_counts(fused)
            loss, mse = real_step(*args, **kwargs)
            steps.append((loss, {k: v - before[k] for k, v in read_counts(fused).items()}))
            return loss, mse

        zero_counts(fused)
        trainer.train_step = counted_step
        try:
            with plain_scene_mlp_calls(NeRFMLP, tr.model, plain):
                t0 = time.perf_counter()
                tr.train()
                torch.cuda.synchronize()
                res["trainer_s"] = time.perf_counter() - t0
        finally:
            trainer.train_step = real_step
        count(read_counts(fused))
        expect = step_launches(fused, "remat_f32", POINT_CHUNK,
                               (cfg.N_rand * 5 * 64, cfg.N_rand * 5 * 128))
        res["trainer_launches_per_iteration"] = [c for _, c in steps]
        res["trainer_plain_scene_mlp_calls"] = plain[0]
        losses = [loss.item() for loss, _ in steps]
        res["trainer_losses"] = losses
        assert len(steps) == PE_TRAINER_ITERS and all(c == expect for _, c in steps), \
            ([c for _, c in steps], expect)
        assert plain[0] == 0 and all(np.isfinite(losses)), (plain, losses)
        view = int(tr.i_test[0])
        zero_counts(fused)
        with plain_scene_mlp_calls(NeRFMLP, tr.model, plain), torch.no_grad():
            rgb = tr.render_pose(tr.poses[view])[0]
        torch.cuda.synchronize()
        eval_counts = count(read_counts(fused))
        from lushnerf_torch.utils.metrics import compute_img_metric
        gt = tr._gt_at_eval_res([view])
        res["eval_view"] = dict(view=view, hw=list(rgb.shape[:2]), launches=eval_counts,
                                psnr=compute_img_metric(rgb[None], gt, "psnr"))
        n_chunks = -(-tr.H_eval * tr.W_eval // cfg.ray_chunk_eval)
        assert eval_counts == {"nerf_mlp_fwd": 2 * n_chunks, "nerf_mlp_bwd_stash": 0,
                               "nerf_mlp_bwd_remat": 0}, eval_counts
        assert plain[0] == 0 and np.isfinite(res["eval_view"]["psnr"]), res["eval_view"]
        del tr
    finally:
        tmp.cleanup()
    print(f"  pe Trainer at {PE_PATH}: {PE_TRAINER_ITERS} iterations in {res['trainer_s']:.2f} s, "
          f"launches each " + json.dumps(res["trainer_launches_per_iteration"][0])
          + ", losses " + json.dumps(losses) + "; eval view " + json.dumps(res["eval_view"]),
          flush=True)
    part_done("trainer")

    # one step's grads at PE_PATH, the kernels (f32 remat at POINT_CHUNK)
    # against torch f32 on the same draws (a comparison: not counted)
    batch = train_batch()
    lcs = {}
    for variant in ("remat_f32", "torch"):
        cfg, _ = train_cfg(cfg_mod, variant, POINT_CHUNK)
        cfg.multires, cfg.multires_views = nfx, nfd
        lcs[variant] = cfg.lush_config()
    rnd = lush._train_randomness(torch.Generator(device="cuda").manual_seed(3), lcs["torch"],
                                 N_RAYS * lcs["torch"].rbk.num_rays_out, torch.device("cuda"))
    grads = {}
    for variant, lc in lcs.items():
        model = lush.LushNeRF(lc, seed=0, device="cuda")
        loss, _ = trainer.loss_fn(model, lc, H, W, FOCAL, batch, "kernel", rand_override=rnd)
        loss.backward()
        grads[variant] = grads_of(model)
        del model, loss
    cos = grad_cosines(grads["remat_f32"], grads["torch"])
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    res["grad_cos"] = {"min": worst[0][1], "worst": worst, "params": len(cos)}
    print(f"  pe grad cosines vs torch f32 at {PE_PATH} (float32 remat), worst 5 of {len(cos)}: "
          + json.dumps(worst), flush=True)
    assert worst[0][1] >= GRAD_COS_MIN["float32"], worst
    del grads
    torch.cuda.empty_cache()
    part_done("grads")
    res["render_bf16"] = pe_render(fused, lush, cfg_mod)
    count(res["render_bf16"]["launches"])
    part_done("render")
    res["launches_bf16"] = res["render_bf16"]["launches"]["nerf_mlp_fwd"]
    print("  pe launches on its path: " + json.dumps(res["launches"]) + " (K1 bf16 "
          + str(res["launches_bf16"]) + " of them); seconds by part: "
          + json.dumps({k: round(v, 1) for k, v in res["seconds"].items()}), flush=True)
    return res


TONEMAP_RENDER = 4  # the split_linear render's factor: a 100 x 100 view, the eval's


def tonemap_phase(fused, lush, cfg_mod, trainer):
    """The learned tone maps on the shipped scene step (poster: f32 remat
    at POINT_CHUNK, full width, N_RAYS rays): under 'learn', one kernel
    step (launches counted), plain torch f32's grads and the float64
    step's on the same draws; each parameter whose torch f32 grad carries a
    direction (cosine against float64 >= GRAD_COS_MIN: the scene MLPs and
    the tone map's 4 layers among them) held at GRAD_COS_MIN against torch
    f32, the rest (the RBK's) by RBK_F64_FACTOR against float64.  Then one
    render_image view under 'split_linear' against its torch f32 render."""
    dev = torch.device("cuda")
    res = {"launches_total": {k: 0 for k in COUNTERS}}
    cfg = cfg_mod.Config.from_file(TRAINER_CONFIG, tone_mapping_type="learn")
    cfg.num_images = NUM_IMAGES
    lc = cfg.lush_config()
    assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype, lc.render.mlp_bwd,
            lc.render.point_chunk, cfg.netwidth) == ("cuda", "float32", "remat", POINT_CHUNK, 256)
    batch = train_batch()
    rnd = lush._train_randomness(torch.Generator(device=dev).manual_seed(5), lc,
                                 N_RAYS * lc.rbk.num_rays_out, dev)
    model = lush.LushNeRF(lc, seed=0, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = trainer.make_optimizer(cfg, model)
    zero_counts(fused)
    loss, _ = trainer.train_step(model, opt, sched, lc, H, W, FOCAL, batch, "kernel",
                                 rand_override=rnd)
    torch.cuda.synchronize()
    res["launches_total"] = read_counts(fused)
    res["loss"] = loss.item()
    kernel = {n: p.grad.cpu() for n, p in model.named_parameters()}

    model.load_state_dict(init)
    model.zero_grad(set_to_none=True)
    plain = dataclasses.replace(lc, render=dataclasses.replace(lc.render, mlp_backend="torch"))
    trainer.loss_fn(model, plain, H, W, FOCAL, batch, "kernel", rand_override=rnd)[0].backward()
    torch_f32 = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
    m64, lc64, b64 = trainer.float64_copy(model, lc, batch)
    rnd64 = {k: None if v is None else v.double() for k, v in rnd.items()}
    trainer.loss_fn(m64, lc64, H, W, FOCAL, b64, "kernel", rand_override=rnd64)[0].backward()
    # the parameters the stage reaches (the kernel step's grad of the others
    # is train_step's zero)
    f64 = {n: p.grad.cpu() for n, p in m64.named_parameters() if p.grad is not None}
    del m64, b64, opt, sched
    assert set(f64) == set(torch_f32), set(f64) ^ set(torch_f32)
    res["params_unreached"] = sorted(set(kernel) - set(f64))
    assert all(not kernel[n].any() for n in res["params_unreached"]), res["params_unreached"]

    res.update(f64_rows({"kernel": kernel, "torch_f32": torch_f32}, f64, "learn"))
    carries = [n for n in f64 if cosine(torch_f32[n], f64[n]) >= GRAD_COS_MIN["float32"]]
    cos = {n: cosine(kernel[n], torch_f32[n]) for n in carries}
    res["grads_held"] = f"{len(carries)} of {len(f64)}"
    res["grad_cos_min"] = min(cos.values())
    res["grad_cos_worst"] = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    res["grad_cos_tonemap"] = {n: v for n, v in cos.items() if n.startswith("tonemapping.")}
    tonemap_params = [n for n in f64 if n.startswith("tonemapping.")]
    print(f"  tonemap 'learn': K1 / K3 launches {res['launches_total']}; grad cosines against "
          f"torch f32 on the {res['grads_held']} parameters that carry a direction, worst 5: "
          f"{json.dumps(res['grad_cos_worst'])}; the tone map's: "
          f"{json.dumps(res['grad_cos_tonemap'])}", flush=True)
    assert np.isfinite(res["loss"])
    assert res["launches_total"] == step_launches(fused, "remat_f32", POINT_CHUNK), res
    assert res["launches_total"]["nerf_mlp_bwd_remat"] == 75
    assert len(tonemap_params) == 8 and set(tonemap_params) <= set(carries), tonemap_params
    assert all(is_rbk(n) for n in f64 if n not in carries), res["grads_held"]
    assert res["grad_cos_min"] >= GRAD_COS_MIN["float32"], res["grad_cos_worst"]
    del model

    # one view under split_linear, the kernel path against plain torch f32
    lc = dataclasses.replace(lc, tone_mapping_type="split_linear")
    model = lush.LushNeRF(lc, seed=1, device=dev)
    hr, wr = H // TONEMAP_RENDER, W // TONEMAP_RENDER
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32) / TONEMAP_RENDER
    K[2, 2] = 1.0
    c2w = np.eye(3, 4, dtype=np.float32)
    zero_counts(fused)
    got = lush.render_image(model, lc, hr, wr, K, c2w, TRAINER_RAY_CHUNK_EVAL)
    torch.cuda.synchronize()
    counts = read_counts(fused)
    for k, v in counts.items():
        res["launches_total"][k] += v
    want = lush.render_image(model, dataclasses.replace(lc, render=dataclasses.replace(
        lc.render, mlp_backend="torch")), hr, wr, K, c2w, TRAINER_RAY_CHUNK_EVAL)
    for key, g, w in zip(("rgb", "noise", "depth"), got, want):
        res[f"split_linear_{key}_err_vs_torch"] = max_err(g, w)
    res["split_linear_render_launches"] = counts["nerf_mlp_fwd"]
    print(f"  tonemap 'split_linear': render_image {hr}x{wr}, {counts['nerf_mlp_fwd']} K1 f32 "
          f"launches, max abs err against torch f32: rgb "
          f"{res['split_linear_rgb_err_vs_torch']:.3g}, noise "
          f"{res['split_linear_noise_err_vs_torch']:.3g}, depth "
          f"{res['split_linear_depth_err_vs_torch']:.3g}", flush=True)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert counts["nerf_mlp_fwd"] == 2 * -(-hr * wr // TRAINER_RAY_CHUNK_EVAL)
    assert res["split_linear_rgb_err_vs_torch"] < 1e-4, res
    assert res["split_linear_depth_err_vs_torch"] < 1e-3, res
    return res


# the trainer phase: the shipped poster config (f32 remat at POINT_CHUNK,
# full width) on an in-process scene of the flagship's 29 views at 400x400,
# through the staged schedule in 60 iterations
TRAINER_CONFIG = Path(__file__).resolve().parent / "configs" / "poster"
TRAINER_OVERRIDES = dict(N_iters=60, kernel_start_iter=20, allkernel_start_iter=40,
                         noisenerf_start_iter=10**9, i_print=10, i_weights=30, i_testset=60,
                         render_factor=4)
TRAINER_RENDER_POSES = 2
# the loop's ms per iteration over bare train_step calls on batches of the
# same dataset: the loop must add no per-step host work (a gather, a copy,
# a sync) to a step the host already holds
LOOP_OVER_STEP_MAX = 1.25


def synthetic_scene(seed: int = 0, n: int = NUM_IMAGES) -> dict:
    """A forward-facing scene made in numpy from a seed, as Trainer's `data=`:
    n views at H x W of a smooth coloured pattern that shifts with the
    camera, which stands on a grid of small offsets looking down -z."""
    h, w = H, W
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    freq = rng.uniform(3.0, 9.0, (3, 2)).astype(np.float32)
    phase = rng.uniform(0.0, 2 * np.pi, 3).astype(np.float32)
    images, poses = [], []
    for i in range(n):
        dx, dy = 0.04 * (i % 6 - 2.5), 0.04 * (i // 6 - 2.0)
        img = np.stack([0.35 + 0.25 * np.sin(freq[c, 0] * (xx + 0.1 * dx) + phase[c])
                        * np.cos(freq[c, 1] * (yy - 0.1 * dy)) for c in range(3)], -1)
        img += 0.02 * rng.standard_normal(img.shape).astype(np.float32)
        images.append(np.clip(img, 0.0, 1.0))
        pose = np.eye(3, 4, dtype=np.float32)
        pose[:, 3] = [dx, dy, 0.0]
        poses.append(pose)
    poses = np.stack(poses)
    return dict(images=np.stack(images), poses=poses,
                bds=np.tile(np.array([[1.0, 5.0]], np.float32), (n, 1)),
                render_poses=poses[:TRAINER_RENDER_POSES], hwf=(h, w, FOCAL))


LPIPS_VIEWS = 2
LPIPS_RTOL = 1e-5  # the card against the CPU, TF32 off (utils/lpips.py)


def lpips_weights(out: Path, seed: int = 0):
    """(trunk path, heads path): random AlexNet `features.*` and v0.1 heads
    `lin{i}.model.1.weight` drawn at init scales from a numpy seed and
    written by torch.save, as the real files would be."""
    from lushnerf_torch.utils import lpips

    rng = np.random.default_rng(seed)
    trunk, cin = {}, 3
    for i, (oc, k, _, _) in zip(lpips._ALEX_CONV_IDS, lpips._ALEX_CONVS):
        bound = 1.0 / np.sqrt(cin * k * k)
        trunk[f"features.{i}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, (oc, cin, k, k)).astype(np.float32))
        trunk[f"features.{i}.bias"] = torch.from_numpy(
            rng.uniform(-bound, bound, oc).astype(np.float32))
        cin = oc
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0.0, 0.1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(lpips._STAGE_CHANNELS)}
    torch.save(trunk, out / "alexnet.pth")
    torch.save(heads, out / "alex_v01.pth")
    return str(out / "alexnet.pth"), str(out / "alex_v01.pth")


def lpips_card_vs_cpu(rgbs: torch.Tensor, gt: torch.Tensor, out: Path) -> dict:
    """LPIPS of each render against its GT ([N, h, w, 3] in [0, 1]) on
    random weights, on the card and on the CPU; and why the real metric is
    unavailable (its pretrained weights are not in the repository)."""
    from lushnerf_torch.utils import lpips

    alex, lin = lpips_weights(out)
    vals = {}
    for dev in ("cuda", "cpu"):
        params = lpips.load_weights(alex, lin, device=dev)
        a, b = (torch.clamp(t.to(dev) * 2 - 1, -1, 1) for t in (rgbs, gt))
        vals[dev] = [lpips.lpips_pair(params, x, y).item() for x, y in zip(a, b)]
    res = {"lpips_card": vals["cuda"], "lpips_cpu": vals["cpu"],
           "lpips_max_rel_err": max(abs(c - p) / abs(p) for c, p in zip(vals["cuda"], vals["cpu"])),
           "lpips_unavailable_reason": lpips.unavailable_reason()}
    print(f"  trainer: LPIPS on random weights, {len(rgbs)} views at {rgbs.shape[1]}x"
          f"{rgbs.shape[2]}: card {res['lpips_card']} against the CPU's {res['lpips_cpu']} "
          f"(max rel err {res['lpips_max_rel_err']:.3g}); the real metric: "
          f"{res['lpips_unavailable_reason']}", flush=True)
    assert all(np.isfinite(v) and v > 0 for v in vals["cuda"]), res
    assert res["lpips_max_rel_err"] <= LPIPS_RTOL, res
    return res


def trainer_phase(fused, cfg_mod, trainer):
    """The trainer a user runs, on the card: Trainer(cfg) from
    Config.from_file with the shipped poster config and the datadir of a
    scene written as PNG files, through naive / kernel / allkernel, its eval,
    checkpoints, a second Trainer resuming from them, render_only; then
    the loop's ms per iteration against bare train_step calls."""
    from lushnerf_torch.data.rays import FIELDS

    from lushnerf_torch.data.llff import load_llff_data, write_llff_scene

    res = {}
    scene = synthetic_scene()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")
    # the scene as a user's LLFF directory of PNGs: images/ with every row
    # filter 0-4 (as a writer that picks each row's filter may leave them),
    # the preprocess cache images_preprocess/ with sub rows (as OpenCV's
    # imwrite writes it); read back with no image package through both of
    # read_png's paths, the cache (rows) as a run reads it and images/
    # (wavefront) with preprocess off, each bit for bit the scene's uint8
    # values; the Trainer then trains from the cache
    datadir = Path(tmp.name) / "scene"
    images_u8 = np.round(scene["images"] * 255).astype(np.uint8)
    t0 = time.perf_counter()
    write_llff_scene(datadir, images_u8, scene["poses"], scene["bds"], FOCAL,
                     filters=np.arange(H) % 5, cache_filters=1)
    res["scene_write_s"] = time.perf_counter() - t0
    for key, preprocess in (("cache_sub_rows", True), ("images_filters_0_4", False)):
        t0 = time.perf_counter()
        loaded = load_llff_data(datadir, preprocess=preprocess)
        res[f"scene_load_s_{key}"] = time.perf_counter() - t0
        res[f"scene_bitwise_{key}"] = bool(np.array_equal(loaded.images,
                                                          (images_u8 / 255.0).astype(np.float32)))
        assert res[f"scene_bitwise_{key}"] and loaded.poses[0, :, 4].tolist() == [H, W, FOCAL], res
    print(f"  trainer: scene of {len(images_u8)} PNG views at {H}x{W} written in "
          f"{res['scene_write_s']:.3f} s; loaded in {res['scene_load_s_cache_sub_rows']:.3f} s "
          f"from the cache (sub rows, read_png's row path) and in "
          f"{res['scene_load_s_images_filters_0_4']:.3f} s from images/ (filters 0-4, its "
          f"wavefront); both bitwise the scene's uint8 values", flush=True)
    del loaded

    def make_cfg():
        return cfg_mod.Config.from_file(TRAINER_CONFIG, basedir=f"{tmp.name}/logs",
                                        tbdir=f"{tmp.name}/tb", datadir=str(datadir),
                                        **TRAINER_OVERRIDES)

    steps = []  # (stage, loss on the device, launches) of each iteration
    real_step = trainer.train_step

    def counted_step(model, opt, sched, lc, h, w, focal, batch, stage, *args, **kwargs):
        before = read_counts(fused)
        loss, mse = real_step(model, opt, sched, lc, h, w, focal, batch, stage, *args, **kwargs)
        steps.append((stage, loss, {k: v - before[k] for k, v in read_counts(fused).items()}))
        return loss, mse

    eval_s = []

    def timed_eval(tr):
        real_eval = tr.eval_testset

        def run(i, save=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_eval(i, save)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t0)
            return out

        tr.eval_testset = run

    try:
        cfg = make_cfg()
        lc = cfg.lush_config()
        # the shapes at which phases 3 and 4 hold K1 and K3 against their
        # plain versions are this config's
        assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype, lc.render.mlp_bwd,
                lc.render.point_chunk, cfg.netwidth, lc.render.n_samples,
                lc.render.n_importance, cfg.rbk_num_motion, cfg.N_rand,
                cfg.ray_chunk_eval) == (
            "cuda", "float32", "remat", POINT_CHUNK, 256, 64, 64, 4, TRAINER_N_RAND,
            TRAINER_RAY_CHUNK_EVAL), lc
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = trainer.Trainer(cfg, device="cuda")
        tr.setup()
        torch.cuda.synchronize()
        res["setup_s"] = time.perf_counter() - t0
        res["dataset_rays"] = len(tr.dataset)
        res["dataset_gb"] = sum(getattr(tr.dataset, k).nbytes for k in FIELDS) / 1e9
        timed_eval(tr)
        trainer.train_step = counted_step
        try:
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            res["train_60_s"] = time.perf_counter() - t0
        finally:
            trainer.train_step = real_step
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

        # launches: each iteration as step_launches reckons its stage's points
        naive_pts = (cfg.N_rand * 64, cfg.N_rand * 128)
        kernel_pts = (cfg.N_rand * 5 * 64, cfg.N_rand * 5 * 128)
        expect = {"naive": step_launches(fused, "remat_f32", POINT_CHUNK, naive_pts),
                  "kernel": step_launches(fused, "remat_f32", POINT_CHUNK, kernel_pts),
                  "allkernel": step_launches(fused, "remat_f32", POINT_CHUNK, kernel_pts)}
        stages = [s for s, _, _ in steps]
        assert stages == ["naive"] * 19 + ["kernel"] * 20 + ["allkernel"] * 21, stages
        res["launches_per_stage"] = {st: steps[stages.index(st)][2] for st in expect}
        wrong = [(i + 1, st, n) for i, (st, _, n) in enumerate(steps) if n != expect[st]]
        assert not wrong, ("launches per iteration", wrong[:3], expect)
        losses = [loss.item() for _, loss, _ in steps]
        res["losses"] = losses
        res["loss_mean_1_10"] = float(np.mean(losses[:10]))
        res["loss_mean_51_60"] = float(np.mean(losses[50:]))
        logged = [json.loads(line) for line in tr.log_file.read_text().splitlines()]
        res["printed"] = [(r["step"], r["stage"], r["loss"]) for r in logged]
        assert [r["step"] for r in logged] == [10, 20, 30, 40, 50, 60], logged
        assert all(np.isfinite(r["loss"]) for r in logged) and all(np.isfinite(losses)), logged
        assert res["loss_mean_51_60"] < res["loss_mean_1_10"], "the loss did not fall"

        # eval at 60: its PNGs and a finite PSNR and SSIM
        n_views = len(scene["poses"])
        out = tr.exp_dir / "testset_000060"
        assert sorted(p.name for p in out.iterdir()) == sorted(
            f"{v:03d}{sfx}.png" for v in range(n_views) for sfx in ("", "_noise", "_blur"))
        line = tr.metrics_file.read_text().strip().splitlines()[-1]
        res["eval_line"] = line
        vals = dict(kv.split(":") for kv in line.split(" ")[1:])
        res["eval_psnr"], res["eval_ssim"] = float(vals["PSNR"]), float(vals["SSIM"])
        assert np.isfinite(res["eval_psnr"]) and np.isfinite(res["eval_ssim"]), line
        assert len(eval_s) == 1, eval_s
        res["eval_views"] = n_views
        res["eval_hw"] = [tr.H_eval, tr.W_eval]
        res["eval_ms_per_view"] = eval_s[0] * 1e3 / n_views
        assert [p.name for p in sorted(tr.exp_dir.glob("*.ckpt"))] == ["000030.ckpt",
                                                                       "000060.ckpt"]
        views = tr.i_test[:LPIPS_VIEWS]
        res.update(lpips_card_vs_cpu(torch.stack([tr.render_pose(tr.poses[v])[0] for v in views]),
                                     tr._gt_at_eval_res(views), Path(tmp.name)))

        # a second Trainer resumes from 000060.ckpt, bit for bit, and trains on
        tr2 = trainer.Trainer(make_cfg(), device="cuda")
        tr2.setup()
        assert tr2.start_step == 60, tr2.start_step
        sd2 = tr2.model.state_dict()
        for k, v in tr.model.state_dict().items():
            assert torch.equal(v, sd2[k]), k
        st1, st2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
        assert st1["state"].keys() == st2["state"].keys()
        for i, s1 in st1["state"].items():
            for k, v in s1.items():
                assert torch.equal(v.cpu(), st2["state"][i][k].cpu()), (i, k)
        assert st1["param_groups"][0]["lr"] == st2["param_groups"][0]["lr"]
        res["resume_bitwise"] = True
        del tr
        torch.cuda.empty_cache()
        tr2.cfg.i_print = 5  # the 5th iteration's loss reaches the host
        out5 = tr2.train(65)
        assert tr2.step == 65 and np.isfinite(out5["loss"]), out5
        res["resumed_loss_65"] = out5["loss"]

        # render_only: the path's frames (the loader's spiral has 120 poses:
        # the first TRAINER_RENDER_POSES of them)
        tr2.render_poses = tr2.render_poses[:TRAINER_RENDER_POSES]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = tr2.render_only()
        torch.cuda.synchronize()
        res["render_only_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / TRAINER_RENDER_POSES
        outdir = tr2.exp_dir / "renderonly_path_000060"
        assert frames == {"frames": TRAINER_RENDER_POSES}
        assert len(list(outdir.glob("path_*.png"))) == 2 * TRAINER_RENDER_POSES

        # the loop against bare train_step calls, 2 allkernel iterations
        # each, in turns, with nothing at a cadence inside the loop's window
        for key in ("i_print", "i_tensorboard", "i_weights", "i_testset"):
            setattr(tr2.cfg, key, 10**9)
        n = 2
        batches = [tr2.dataset.next_batch(tr2.cfg.N_rand, tr2.np_rng) for _ in range(n)]

        def loop():
            first = tr2.step + 1
            tr2.train(tr2.step + n)
            assert trainer.stage_for_iter(first, tr2.cfg.kernel_start_iter,
                                          tr2.cfg.allkernel_start_iter) == "allkernel"

        def bare():
            for b in batches:
                trainer.train_step(tr2.model, tr2.optimizer, tr2.scheduler, tr2.lush_cfg, tr2.H,
                                   tr2.W, tr2.focal, b, "allkernel", tr2.generator,
                                   grad_clip_norm=tr2.cfg.grad_clip_norm)

        windows = {"loop": [], "train_step": []}
        for name, fn in (("loop", loop), ("train_step", bare), ("train_step", bare),
                         ("loop", loop)):
            windows[name].append(window_ms(fn, 1)[0] / n)
        res["loop_ms_per_iter"] = windows["loop"]
        res["train_step_ms"] = windows["train_step"]
        res["loop_over_train_step"] = float(np.mean(windows["loop"]) / np.mean(windows["train_step"]))
    finally:
        tmp.cleanup()
    print("  trainer: " + json.dumps({k: v for k, v in res.items() if k != "losses"}), flush=True)
    print(f"  trainer loop vs train_step ({n} allkernel iterations each, f32 remat at point_chunk "
          f"{POINT_CHUNK}): loop {res['loop_ms_per_iter']} ms/iter, train_step "
          f"{res['train_step_ms']} ms, ratio {res['loop_over_train_step']:.4f}; eval "
          f"{res['eval_ms_per_view']:.2f} ms/view at {res['eval_hw'][0]}x{res['eval_hw'][1]}; "
          f"peak {res['peak_mem_gb']:.3f} GB ({res['dataset_gb']:.3f} GB dataset)", flush=True)
    assert res["loop_over_train_step"] < LOOP_OVER_STEP_MAX, res["loop_over_train_step"]
    return res


CTE_OVERRIDES = dict(N_iters=40, kernel_start_iter=10, allkernel_start_iter=20,
                     noisenerf_start_iter=30, rematch_interval=30, i_print=10, i_weights=40,
                     i_testset=10**9, render_factor=4)
CTE_DKM_VIEWS = 3  # views the cte phase renders for the dkm phase


def cte_phase(fused, cfg_mod, trainer):
    """CTE on the card: Trainer(cfg, data=scene, matcher=GridStubMatcher())
    with the shipped poster config (f32 remat at POINT_CHUNK, full width)
    through naive, kernel, allkernel and, from iteration 30, the consist
    pass (its weight 0 at 30, CONSIST_WEIGHT after); the rematch at 30
    renders the 25 train views at the eval resolution and writes its
    tables; a second Trainer resumes from 000040.ckpt with the tables bit
    for bit (its cfg.matcher, dkm, finds no weights and falls back).  Then
    ms per consist iteration against a plain allkernel one, in turns.
    Returns its results, with the trained model's renders of CTE_DKM_VIEWS
    train views under "views" (for the dkm phase)."""
    from lushnerf_torch.matcher.api import GridStubMatcher
    from lushnerf_torch.train.losses import CONSIST_WEIGHT

    res = {}
    scene = synthetic_scene()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cte_")

    def make_cfg():
        return cfg_mod.Config.from_file(TRAINER_CONFIG, basedir=f"{tmp.name}/logs", tbdir="",
                                        **CTE_OVERRIDES)

    steps = []  # (stage, consist weight or None, loss on the device, launches)
    real_step = trainer.train_step

    def counted_step(model, opt, sched, lc, h, w, focal, batch, stage, *args, **kwargs):
        before = read_counts(fused)
        loss, mse = real_step(model, opt, sched, lc, h, w, focal, batch, stage, *args, **kwargs)
        consist = kwargs.get("consist")
        steps.append((stage, None if consist is None else consist["weight"], loss,
                      {k: v - before[k] for k, v in read_counts(fused).items()}))
        return loss, mse

    rematch_s = []
    try:
        cfg = make_cfg()
        lc = cfg.lush_config()
        assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype, lc.render.mlp_bwd,
                lc.render.point_chunk, cfg.netwidth, lc.render.n_samples, lc.render.n_importance,
                cfg.consist_num_pixels, cfg.consist_threshold, cfg.matcher) == (
            "cuda", "float32", "remat", POINT_CHUNK, 256, 64, 64, CONSIST_PIXELS, 0.8, "dkm"), lc
        stub = GridStubMatcher()
        assert stub.certainty >= cfg.consist_threshold  # the stub's tables feed the loss
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = trainer.Trainer(cfg, data=scene, matcher=stub, device="cuda")
        tr.setup()
        torch.cuda.synchronize()
        res["setup_s"] = time.perf_counter() - t0
        assert len(tr.i_train) == CTE_TRAIN_VIEWS, tr.i_train
        real_rematch = tr.rematch

        def timed_rematch(i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_rematch(i)
            rematch_s.append(time.perf_counter() - t0)

        tr.rematch = timed_rematch
        trainer.train_step = counted_step
        zero_counts(fused)
        try:
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            res["train_40_s"] = time.perf_counter() - t0
        finally:
            trainer.train_step = real_step
        res["launches_total"] = read_counts(fused)
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

        stages = [s for s, _, _, _ in steps]
        assert stages == ["naive"] * 9 + ["kernel"] * 10 + ["allkernel"] * 21, stages
        weights = [w for _, w, _, _ in steps]
        assert weights == [None] * 29 + [0.0] + [CONSIST_WEIGHT] * 10, weights
        naive_pts = (cfg.N_rand * 64, cfg.N_rand * 128)
        kernel_pts = (cfg.N_rand * 5 * 64, cfg.N_rand * 5 * 128)
        consist_pts = (CTE_RAYS * 64, CTE_RAYS * 128)
        expect = {("naive", False): step_launches(fused, "remat_f32", POINT_CHUNK, naive_pts),
                  ("kernel", False): step_launches(fused, "remat_f32", POINT_CHUNK, kernel_pts),
                  ("allkernel", False): step_launches(fused, "remat_f32", POINT_CHUNK, kernel_pts),
                  # the aligned render's loss reads its fine rgb only (the
                  # importance samples are detached): no coarse backward
                  ("allkernel", True): step_launches(fused, "remat_f32", POINT_CHUNK,
                                                     kernel_pts + consist_pts,
                                                     kernel_pts + consist_pts[1:])}
        assert expect[("allkernel", True)]["nerf_mlp_fwd"] == 4
        assert expect[("allkernel", True)]["nerf_mlp_bwd_remat"] == 85
        got = [((st, w is not None), n) for st, w, _, n in steps]
        wrong = [(i + 1, key, n) for i, (key, n) in enumerate(got) if n != expect[key]]
        assert not wrong, ("launches per iteration", wrong[:3], expect)
        res["launches_consist_iteration"] = steps[-1][3]
        res["launches_allkernel_iteration"] = steps[28][3]
        losses = [loss.item() for _, _, loss, _ in steps]
        res["losses_30_40"] = losses[29:]
        assert all(np.isfinite(losses)), losses

        # the rematch at 30: the stub over every ordered pair of the renders,
        # its keypoints brought from the eval resolution to the full one
        assert len(rematch_s) == 1, rematch_s
        res["rematch_s"] = rematch_s[0]
        names = sorted(p.name for p in tr.exp_dir.glob("match_tables_*.npz"))
        assert names == ["match_tables_000030.npz"], names
        tables = tr.match_tables
        assert tables.kpts.shape == (CTE_TRAIN_VIEWS, CTE_TRAIN_VIEWS, stub.n_points, 4)
        assert (tables.certainty == np.float32(stub.certainty)).all()
        assert tr.H_eval < tr.H and 0 < tables.kpts.min() and tables.kpts.max() < tr.W
        res["tables_shape"] = list(tables.kpts.shape)

        # a second Trainer resumes from 000040.ckpt with the tables bit for bit
        t0 = time.perf_counter()
        tr2 = trainer.Trainer(make_cfg(), data=scene, device="cuda")
        tr2.setup()
        res["resume_setup_s"] = time.perf_counter() - t0
        assert tr2.start_step == 40 and tr2._matcher is None, (tr2.start_step, tr2._matcher)
        assert np.array_equal(tr2.match_tables.kpts, tables.kpts)
        assert np.array_equal(tr2.match_tables.certainty, tables.certainty)
        res["resume_tables_bitwise"] = True
        sd2 = tr2.model.state_dict()
        assert all(torch.equal(v, sd2[k]) for k, v in tr.model.state_dict().items())
        del tr
        torch.cuda.empty_cache()

        # the consist batch's host cost: the numpy gather and two uploads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            tr2._sample_consist_batch(41)
        res["consist_batch_host_us"] = (time.perf_counter() - t0) * 1e6 / 200
        torch.cuda.synchronize()

        # consist iterations against plain allkernel ones, in turns, 2 each
        for key in ("i_print", "i_tensorboard", "i_weights", "i_testset"):
            setattr(tr2.cfg, key, 10**9)
        n = 2

        def window(consist: bool):
            tr2.cfg.noisenerf_start_iter = 0 if consist else 10**9
            first = tr2.step + 1
            ms = window_ms(lambda: tr2.train(tr2.step + n), 1)[0] / n
            assert trainer.stage_for_iter(first, tr2.cfg.kernel_start_iter,
                                          tr2.cfg.allkernel_start_iter) == "allkernel"
            return ms

        windows = {"consist": [], "allkernel": []}
        for consist in (True, False, False, True):
            windows["consist" if consist else "allkernel"].append(window(consist))
        res["consist_ms_per_iter"] = windows["consist"]
        res["allkernel_ms_per_iter"] = windows["allkernel"]
        res["consist_over_allkernel"] = float(np.mean(windows["consist"])
                                              / np.mean(windows["allkernel"]))
        res["peak_mem_gb_all"] = torch.cuda.max_memory_allocated() / 1e9

        # views for the dkm phase: the trained model's renders at the eval size
        with torch.no_grad():
            views = np.stack([tr2.render_pose(tr2.poses[v])[0].cpu().numpy()
                              for v in tr2.i_train[:CTE_DKM_VIEWS]])
        res["views_for_dkm"] = list(views.shape)
    finally:
        tmp.cleanup()
    print("  cte: " + json.dumps(res), flush=True)
    print(f"  cte: consist iteration {res['consist_ms_per_iter']} ms vs allkernel "
          f"{res['allkernel_ms_per_iter']} ms (ratio {res['consist_over_allkernel']:.4f}; "
          f"{CTE_RAYS} consist rays, launches {res['launches_consist_iteration']} vs "
          f"{res['launches_allkernel_iteration']}); rematch of {CTE_TRAIN_VIEWS} views "
          f"{res['rematch_s'] * 1e3:.1f} ms; consist batch {res['consist_batch_host_us']:.1f} us "
          f"on the host; peak {res['peak_mem_gb']:.3f} GB", flush=True)
    return dict(res, views=views)


DKM_HS, DKM_WS = 640, 1120  # the reference's match resolution (run_lushnerf.py:349)
# match_many against per-pair match on the card: the same decoder on a
# batch of two other images (the symmetric pair), so sums may run in
# another order; pixel keypoints of a 100-pixel view and certainties
DKM_PAIR_TOL = {"kpts_px": 1e-2, "certainty": 1e-3}
DKM_CPU_SHAPE = (64, 96)  # the card against the CPU, at a small hs x ws
DKM_CPU_TOL = 2e-4  # tests/test_torch_dkm.py's rtol / atol
DKM_REMATCH_VIEWS = CTE_TRAIN_VIEWS


def dkm_phase(images=None):
    """DKMv3 at the published widths (random weights from a seed) and the
    production hs x ws, on the card: match_many over the 9 ordered pairs of
    3 views the cte phase rendered (`images`; None: the scene's own),
    against per-pair match on 2 of them;
    certainties in [0, 1] and finite, keypoints within the image; one pair
    on the card against the CPU at a small shape; ms per encoder pass and
    per ordered pair, peak memory, and the 625-pair rematch of 25 views
    extrapolated from them."""
    from lushnerf_torch.matcher.dkm import PUBLISHED_DIMS, DKM, DKMMatcher, dkm_match
    from lushnerf_torch.matcher.dkm import random_state_dict
    from lushnerf_torch.matcher.dkm.matcher import dkm_match_from_pyramids
    from lushnerf_torch.matcher.dkm.nn import full_f32

    res = {"dims": dataclasses.asdict(PUBLISHED_DIMS), "hs_ws": [DKM_HS, DKM_WS]}
    res["views_from"] = "cte phase renders" if images is not None else "the scene's images"
    if images is None:
        images = synthetic_scene()["images"][:CTE_DKM_VIEWS]
    H, W = images.shape[1:3]
    t0 = time.perf_counter()
    sd = random_state_dict(PUBLISHED_DIMS, seed=0)
    res["params_m"] = sum(v.numel() for v in sd.values()) / 1e6
    model = DKM.from_state_dict(sd).cuda()
    m = DKMMatcher(model, hs=DKM_HS, ws=DKM_WS)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    pairs = [(k, v) for k in range(CTE_DKM_VIEWS) for v in range(CTE_DKM_VIEWS)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.match_many(images, pairs)  # the first call: cuDNN's plans
    torch.cuda.synchronize()
    res["match_many_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kpts, cert = m.match_many(images, pairs)
    res["match_many_s"] = time.perf_counter() - t0
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    P = min(m.max_columns, DKM_HS * DKM_WS)
    assert kpts.shape == (len(pairs), P, 4) and cert.shape == (len(pairs), P), kpts.shape
    assert np.isfinite(kpts).all() and np.isfinite(cert).all()
    assert cert.min() >= 0.0 and cert.max() <= 1.0, (cert.min(), cert.max())
    assert (kpts[..., 0::2] >= 0).all() and (kpts[..., 0::2] <= W).all()
    assert (kpts[..., 1::2] >= 0).all() and (kpts[..., 1::2] <= H).all()
    res["certainty_mean"] = float(cert.mean())
    res["certainty_zero_share"] = float((cert == 0).mean())

    # per-pair (symmetric) match on 2 pairs against match_many's rows
    res["vs_match"] = []
    for pi in (1, 6):
        k, v = pairs[pi]
        k0, k1, c = m.match(images[k], images[v])
        d = {"pair": [k, v], "kpts0_bitwise": bool(np.array_equal(kpts[pi, :, :2], k0)),
             "kpts1_max_px": float(np.abs(kpts[pi, :, 2:] - k1).max()),
             "certainty_max": float(np.abs(cert[pi] - c).max())}
        res["vs_match"].append(d)
        assert d["kpts1_max_px"] <= DKM_PAIR_TOL["kpts_px"], d
        assert d["certainty_max"] <= DKM_PAIR_TOL["certainty"], d
        assert np.abs(kpts[pi, :, :2] - k0).max() <= DKM_PAIR_TOL["kpts_px"], d

    # the parts, host-timed with a sync at each end
    with torch.inference_mode(), full_f32():
        enc = [window_ms(lambda: m.encode(images, range(CTE_DKM_VIEWS)), 1)[0] / CTE_DKM_VIEWS
               for _ in range(3)]
        pyr = m.encode(images, range(CTE_DKM_VIEWS))
        chunk = pairs[:m.pair_batch]
        pyr_q = {s: torch.cat([pyr[a][s] for a, _ in chunk]) for s in pyr[0]}
        pyr_s = {s: torch.cat([pyr[b][s] for _, b in chunk]) for s in pyr[0]}
        dec = [window_ms(lambda: dkm_match_from_pyramids(m.model, pyr_q, pyr_s), 1)[0]
               / len(chunk) for _ in range(3)]
        del pyr, pyr_q, pyr_s
    res["encoder_ms_per_view"] = enc
    res["decoder_ms_per_ordered_pair"] = dec
    res["pair_batch"] = m.pair_batch
    res["match_many_ms_per_ordered_pair"] = res["match_many_s"] * 1e3 / len(pairs)
    n = DKM_REMATCH_VIEWS
    res["rematch_25_views_extrapolated_s"] = (n * np.median(enc) + n * n * np.median(dec)) / 1e3

    # one pair on the card against the CPU at a small shape
    hs, ws = DKM_CPU_SHAPE
    cpu_model = DKM.from_state_dict(sd).eval()
    a, b = (torch.from_numpy(np.ascontiguousarray(images[i].transpose(2, 0, 1))) for i in (0, 1))
    with torch.inference_mode(), full_f32():
        warp_c, cert_c = dkm_match(model, a.cuda(), b.cuda(), hs, ws)
        warp_h, cert_h = dkm_match(cpu_model, a, b, hs, ws)
    err = {"warp": (warp_c.cpu() - warp_h).abs().max().item(),
           "certainty": (cert_c.cpu() - cert_h).abs().max().item()}
    ok = all(torch.allclose(x.cpu(), y, rtol=DKM_CPU_TOL, atol=DKM_CPU_TOL)
             for x, y in ((warp_c, warp_h), (cert_c, cert_h)))
    res["card_vs_cpu"] = {"hs_ws": [hs, ws], "max_abs_err": err, "within_tol": ok}
    print("  dkm: " + json.dumps(res), flush=True)
    print(f"  dkm at {DKM_HS}x{DKM_WS}, {res['params_m']:.1f} M random weights: encoder "
          f"{np.median(enc):.1f} ms a view, decoder {np.median(dec):.1f} ms an ordered pair "
          f"(pair_batch {m.pair_batch}), match_many {res['match_many_ms_per_ordered_pair']:.1f} "
          f"ms a pair; peak {res['peak_mem_gb']:.2f} GB; a rematch of {n} views ({n * n} pairs) "
          f"extrapolated to {res['rematch_25_views_extrapolated_s']:.1f} s", flush=True)
    assert ok, res["card_vs_cpu"]
    return res


# the ddp phase: the shipped poster config's f32 step, data-parallel.  The
# Trainer runs: naive 1-2, kernel 3-4, allkernel from 5, the consist pass
# from 7 (weight 0 at 7), a striped rematch at 8 and a striped eval, a
# checkpoint at 10; a world of 1 runs the same 10 iterations without CTE
DDP_ITERS = 10
DDP_OVERRIDES = dict(N_iters=DDP_ITERS, kernel_start_iter=3, allkernel_start_iter=5,
                     noisenerf_start_iter=7, rematch_interval=8, i_print=5, i_weights=DDP_ITERS,
                     i_testset=DDP_ITERS, render_factor=4)
DDP_WORLD1_OVERRIDES = dict(DDP_OVERRIDES, noisenerf_start_iter=10**9, i_weights=10**9,
                            i_testset=10**9)
DDP_WORLD = 2
RBK_PREFIXES = ("mlp_rbk.", "dbk_view_embedding.")
RBK_F64_FACTOR = 2.0  # see below; the largest ratio seen is 1.42
DDP_WINDOW = 2  # allkernel iterations a timing window
DDP_WAIT_S = 300  # the longest a rank or the phase waits for the other side
# The fixed-batch step of the ranks, each on its half of one global batch,
# against one process on the whole of it, from the same weights, is held by
# its grads: the cosine of all of them together, and of each parameter whose
# f32 grad carries a direction on this batch, at least the f32 step's
# GRAD_COS_MIN.  "Carries a direction": the one process's kernel grad is
# within that cosine of plain torch's f32 grad on the same batch.  The RBK
# grads of the poster config (1e-15-1e-6, cancelling sums over every
# point) are f32 rounding, a known difference and not a fault: against the
# same step in float64 through plain torch (`trainer.float64_copy`) on the
# card, both f32 steps miss each of the 21 RBK grads by |g - g64| / |g64|
# 0.34-9.5 (cosine -0.07-0.95), and the kernel step's error is 0.98-1.42
# times torch f32's (an NVIDIA H100 80GB HBM3 at 700 W).  The two runs that
# gave this gave the same bits, so they are one reading; the second is the
# tonemap phase's step under 'learn' (other params, other draws), where the
# ratio was 0.968-1.303.  So the phase holds each RBK grad's kernel error
# within RBK_F64_FACTOR = 2 of torch f32's.  That hold is coarse: a fault in
# d(xd), the path by which the RBK's grads leave the scene MLPs, shows here
# only once it at least doubles an error that f32 rounding already makes
# 0.34-9.5 times |g64|; a smaller one passes.  d(xd) itself is held at
# K3's limits against its plain version in phase 4, at this step's shapes.
# Between the kernel and plain torch the RBK grads agree to cosine
# 0.93-0.97 only.  The kernels' own grads (the scene MLPs') are always held.  The params after
# the step are held to be Adam's step of the all-reduced grads, bit for
# bit: against the one
# process's params they differ by up to lrate * |dg| / eps for a grad near
# Adam's eps (an update is lrate * g / (|g| + eps)), and the shipped step's
# scene-MLP grads lie near it.


class ContentStub:
    """A matcher keyed on the two images' content, not on the call order:
    ranks that match different pairs agree only if the gather puts each
    pair back in its place."""

    def match(self, img0, img1):
        n = 64
        h, w = img0.shape[:2]
        seed = int(abs(float(img0.sum()) * 1e4 + float(img1.sum()) * 7.0)) % (2 ** 31)
        rng = np.random.default_rng(seed)
        k0 = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], -1).astype(np.float32)
        k1 = np.clip(k0 + rng.normal(0, 0.5, k0.shape), 0, w - 1).astype(np.float32)
        return k0, k1, rng.uniform(0.85, 1.0, n).astype(np.float32)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def params_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def tables_digest(tables) -> str:
    import hashlib

    return hashlib.sha256(tables.kpts.tobytes() + tables.certainty.tobytes()).hexdigest()


def ddp_step_setup(cfg_mod, trainer, device):
    """The fixed-batch step's config (poster, no random draws), its
    LushConfig, a model from seed 0 and Adam: one step is then a function
    of its batch."""
    cfg = cfg_mod.Config.from_file(TRAINER_CONFIG)
    cfg.num_images = NUM_IMAGES
    lc = cfg.lush_config()
    lc = dataclasses.replace(lc, render=dataclasses.replace(lc.render, perturb=False,
                                                            raw_noise_std=0.0))
    from lushnerf_torch.models.lushnerf import LushNeRF

    model = LushNeRF(lc, seed=0, device=device)
    opt, sched = trainer.make_optimizer(cfg, model)
    return cfg, lc, model, opt, sched


def ddp_window_ms(tr, trainer, n=DDP_WINDOW) -> float:
    """Host ms an iteration over n allkernel iterations of tr, with nothing
    at a cadence inside and without the consist pass."""
    for key in ("i_print", "i_tensorboard", "i_weights", "i_testset"):
        setattr(tr.cfg, key, 10**9)
    tr.cfg.noisenerf_start_iter = 10**9
    first = tr.step + 1
    ms = window_ms(lambda: tr.train(tr.step + n), 1)[0] / n
    assert trainer.stage_for_iter(first, tr.cfg.kernel_start_iter,
                                  tr.cfg.allkernel_start_iter) == "allkernel"
    return ms


def ddp_expected_launches(fused, n_rand, consist: bool) -> dict:
    """K1 / K3 launches of one allkernel iteration of a rank drawing n_rand
    rays (5 sub-rays each), with the consist pass's CTE_RAYS if asked."""
    pts = (n_rand * 5 * 64, n_rand * 5 * 128)
    cpts = (CTE_RAYS * 64, CTE_RAYS * 128)
    if consist:
        return step_launches(fused, "remat_f32", POINT_CHUNK, pts + cpts, pts + cpts[1:])
    return step_launches(fused, "remat_f32", POINT_CHUNK, pts)


def wait_for(paths, what: str, alive=lambda: True) -> None:
    """Polls until every path exists; raises after DDP_WAIT_S or once
    alive() is false."""
    t0 = time.time()
    while not all(p.exists() for p in paths):
        if time.time() - t0 > DDP_WAIT_S or not alive():
            raise TimeoutError(f"gave up waiting for {what}")
        time.sleep(0.02)


class DdpRanks:
    """The ddp phase's DDP_WORLD rank processes (this script with
    --ddp_worker), started before the build: a fresh interpreter spends
    ~15 s on the card's machine importing torch and what its optimizer
    pulls in, which the build's nvcc processes then hide.  They wait, touching nothing on the
    card, for the phase's spec.json in their directory.  close() ends them."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_")
        self.out = Path(self.dir.name)
        self.logs = [open(self.out / f"rank{r}.log", "w") for r in range(DDP_WORLD)]
        self.procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                        "--ddp_worker", str(self.out), str(r)],
                                       stdout=log, stderr=subprocess.STDOUT)
                      for r, log in enumerate(self.logs)]

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def log(self, r: int) -> str:
        self.logs[r].flush()
        return (self.out / f"rank{r}.log").read_text()[-6000:]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()
        self.dir.cleanup()


def ddp_worker(out: str, rank: int) -> int:
    """One rank of the ddp phase (`chip_smoke.py --ddp_worker DIR RANK`):
    imports, waits for DIR/spec.json, then the fixed-batch step on its
    half, the Trainer with its striped rematch and eval, a resume from rank
    0's state and timings; writes its results to DIR/rank<r>.json (rank 0
    also the step's params and grads)."""
    out = Path(out)
    from lushnerf_torch import config as cfg_mod
    from lushnerf_torch.matcher.api import build_match_tables
    from lushnerf_torch.ops.fused import nerf_mlp as fused
    from lushnerf_torch.parallel import distributed as dist
    from lushnerf_torch.train import trainer

    torch.optim.Adam([torch.zeros(1, requires_grad=True)])  # its lazy imports, off the card
    scene = synthetic_scene()
    parent = os.getppid()
    wait_for([out / "spec.json"], "the ddp phase", lambda: os.getppid() == parent)
    spec = json.loads((out / "spec.json").read_text())
    clock = {"start": time.time()}
    world = spec["world"]
    assert dist.initialize(spec["coordinator"], world, rank, str(spec["devices"][rank]),
                           backend=spec["backend"])
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"rank": rank, "device": str(dev), "backend": torch.distributed.get_backend(),
           "world": dist.process_count()}

    # 1. one step of the fixed global batch's stripe [rank::world]: this
    # process's first launches, which load the kernels
    cfg, lc, model, opt, sched = ddp_step_setup(cfg_mod, trainer, dev)
    model.load_state_dict(torch.load(spec["init"], map_location=dev, weights_only=True))
    batch = {k: v[rank::world] for k, v in train_batch().items()}
    zero_counts(fused)
    trainer.train_step(model, opt, sched, lc, H, W, FOCAL, batch, "kernel",
                       torch.Generator(device=dev).manual_seed(rank))
    torch.cuda.synchronize()
    clock["step"] = time.time()
    res["step_launches"] = read_counts(fused)
    res["step_digest"] = params_digest(model)
    if rank == 0:
        torch.save({"params": {k: v.cpu() for k, v in model.state_dict().items()},
                    "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}},
                   out / "step_rank0.pt")
    grads = [p.grad.clone() for p in model.parameters()]
    del model, opt

    # 2. the Trainer: stages, the consist pass, a striped rematch and eval
    basedir = out / f"rank{rank}"

    def make_cfg():
        return cfg_mod.Config.from_file(TRAINER_CONFIG, basedir=str(basedir / "logs"), tbdir="",
                                        **DDP_OVERRIDES)

    steps, evals, rematched = [], [], []
    real_step = trainer.train_step

    def counted_step(*args, **kwargs):
        before = read_counts(fused)
        loss, mse = real_step(*args, **kwargs)
        steps.append((args[8], kwargs.get("consist") is not None,
                      {k: v - before[k] for k, v in read_counts(fused).items()}))
        return loss, mse

    torch.cuda.reset_peak_memory_stats()
    tr = trainer.Trainer(make_cfg(), data=scene, matcher=ContentStub(), device="cuda")
    tr.setup()
    clock["setup"] = time.time()
    res["dataset_rays"], res["local_n_rand"] = len(tr.dataset), tr.local_n_rand
    real_eval, real_tables = tr.eval_testset, tr._build_tables_striped
    tr.eval_testset = lambda i, save=True: evals.append(real_eval(i, save)) or evals[-1]

    def tables_striped(renders):
        got = real_tables(renders)
        rematched.append(got)
        single = build_match_tables(tr._matcher, renders)
        res["tables_equal_single_process"] = bool(
            np.array_equal(got.kpts, single.kpts) and np.array_equal(got.certainty, single.certainty))
        return got

    tr._build_tables_striped = tables_striped
    trainer.train_step = counted_step
    zero_counts(fused)
    try:
        out_train = tr.train()
        torch.cuda.synchronize()
    finally:
        trainer.train_step = real_step
    clock["train"] = time.time()
    res["launches"] = read_counts(fused)
    res["stages"] = [(st, c) for st, c, _ in steps]
    expect = {(st, c): ddp_expected_launches(fused, tr.local_n_rand, c) for st, c, _ in steps
              if st != "naive"}
    expect[("naive", False)] = step_launches(fused, "remat_f32", POINT_CHUNK,
                                             (tr.local_n_rand * 64, tr.local_n_rand * 128))
    res["launches_per_iteration"] = {f"{st}{'+consist' if c else ''}": n for st, c, n in steps}
    res["launches_wrong"] = [(i + 1, st, c, n) for i, (st, c, n) in enumerate(steps)
                             if n != expect[(st, c)]]
    res["loss"] = out_train["loss"]
    res["evals"] = evals
    res["rematches"] = len(rematched)
    res["tables_digest"] = tables_digest(tr.match_tables)
    res["tables_certainty_max"] = float(tr.match_tables.certainty.max())
    res["params_digest"] = params_digest(tr.model)
    res["files"] = sorted(str(p.relative_to(basedir)) for p in basedir.rglob("*") if p.is_file())

    # 3. a resume from rank 0's state (rank 1's basedir is empty), then the
    # timing windows
    tr2 = trainer.Trainer(make_cfg(), data=scene, matcher=ContentStub(), device="cuda")
    tr2.setup()
    clock["resume"] = time.time()
    res["resumed_step"] = tr2.start_step
    res["resumed_params_digest"] = params_digest(tr2.model)
    res["resumed_tables_digest"] = tables_digest(tr2.match_tables)
    del tr
    # what is timed from here on waits until the phase's own work is done
    (out / f"untimed_done{rank}").touch()
    wait_for([out / "go_timed"], "the phase's go for the timed part",
             lambda: os.getppid() == parent)
    clock["go_timed"] = time.time()
    res["allreduce_floats"] = sum(g.numel() for g in grads)
    res["allreduce_ms"] = per_call_ms(lambda: dist.all_reduce_mean_(grads), 10)
    del grads
    res["ms_per_iter"] = [ddp_window_ms(tr2, trainer) for _ in range(2)]
    res["window_params_digest"] = params_digest(tr2.model)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    clock["windows"] = time.time()
    res["clock_s"] = {k: round(v - clock["start"], 2) for k, v in clock.items()}
    (out / f"rank{rank}.json").write_text(json.dumps(res, default=str))
    torch.distributed.destroy_process_group()
    return 0


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()


def is_rbk(name: str) -> bool:
    return name.startswith(RBK_PREFIXES)


def rel_l2(g: torch.Tensor, ref: torch.Tensor) -> float:
    g, ref = g.double().flatten(), ref.double().flatten()
    return ((g - ref).norm() / ref.norm().clamp_min(1e-300)).item()


def f64_rows(sides: dict, f64: dict, tag: str) -> dict:
    """Each f32 step's grads (`sides`: name -> grads) against the float64
    step's: for every parameter the cosine, |g - g64| / |g64| and
    max |g - g64|; printed,
    the worst 5 of each side by that error and every RBK parameter's row;
    held: each RBK grad's kernel error within RBK_F64_FACTOR of torch
    f32's (the kernels change nothing on the RBK's path but the scene MLPs'
    sums)."""
    names = sorted(f64)
    rows = {n: {side: [cosine(g[n], f64[n]), rel_l2(g[n], f64[n]),
                       (g[n].double() - f64[n]).abs().max().item()]
                for side, g in sides.items()} for n in names}
    res = {"f64_rows": rows, "f64_params": len(names),
           "f64_max_abs_g64": {n: f64[n].abs().max().item() for n in names if is_rbk(n)}}
    for side in sides:
        worst = sorted(names, key=lambda n: -rows[n][side][1])[:5]
        print(f"  f64 step ({tag}): {side} f32 grads, worst 5 of {len(names)} by "
              f"|g - g64| / |g64|: "
              + json.dumps([[n, *rows[n][side]] for n in worst]), flush=True)
    rbk = [n for n in names if is_rbk(n)]
    ratio = {n: rows[n]["kernel"][1] / max(rows[n]["torch_f32"][1], 1e-300) for n in rbk}
    res["f64_rbk_kernel_over_torch"] = ratio
    res["f64_rbk_ratio_max"] = max(ratio.values())
    print(f"  f64 step ({tag}): the {len(rbk)} RBK parameters [cosine, |g - g64| / |g64|, "
          f"max |g - g64|] of the kernel step and of torch f32, and max |g64|:", flush=True)
    for n in rbk:
        print(f"    {n}: kernel {rows[n]['kernel']} torch_f32 {rows[n]['torch_f32']} ratio "
              f"{ratio[n]:.4f} max|g64| {res['f64_max_abs_g64'][n]:.3e}", flush=True)
    assert res["f64_rbk_ratio_max"] <= RBK_F64_FACTOR, ratio
    return res


def ddp_phase(fused, cfg_mod, trainer, ranks: DdpRanks):
    """Data-parallel training on the card (lushnerf_torch.parallel): a
    world of 1 (NCCL in this process) against no process group, bit for
    bit; then the DDP_WORLD `ranks` (NCCL, one card each, where the machine
    has DDP_WORLD cards; else gloo, all on card 0): the fixed-batch step
    against this process's step on the whole batch, the Trainer with its
    striped rematch and eval, a resume from rank 0's state.  The ranks run
    their step and Trainer beside this process's untimed work; then this
    process times its world of 1, and after it the ranks time theirs (the
    all-reduce, the windows), each while the other waits."""
    from lushnerf_torch.parallel import distributed as dist

    res = {}
    out = ranks.out
    scene = synthetic_scene()
    dev = torch.device("cuda", 0)
    cfg, lc, model, opt, sched = ddp_step_setup(cfg_mod, trainer, dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(init, out / "init.pt")
    n_cards = torch.cuda.device_count()
    backend, devices = (("nccl", list(range(DDP_WORLD))) if n_cards >= DDP_WORLD
                        else ("gloo", [0] * DDP_WORLD))
    res.update(backend=backend, world=DDP_WORLD, devices=devices,
               shared_card=len(set(devices)) < DDP_WORLD)
    (out / "spec.json.tmp").write_text(json.dumps({
        "coordinator": f"127.0.0.1:{free_port()}", "world": DDP_WORLD, "backend": backend,
        "devices": devices, "init": str(out / "init.pt")}))
    (out / "spec.json.tmp").rename(out / "spec.json")
    t_ranks = time.perf_counter()

    # a world of 1: the all-reduce and the striped paths give the bits of
    # no process group
    def world1_trainer(name):
        cfg = cfg_mod.Config.from_file(TRAINER_CONFIG, basedir=str(out / name), tbdir="",
                                       **DDP_WORLD1_OVERRIDES)
        tr = trainer.Trainer(cfg, data=scene, device="cuda")
        tr.setup()
        return tr

    t0 = time.perf_counter()
    ranks_ok = lambda: all(p.poll() in (None, 0) for p in ranks.procs)  # noqa: E731
    # untimed, beside the ranks' step and Trainer: the world of 1 without a
    # process group, then the whole global batch in this process from the
    # weights the ranks load, beside it the control, plain torch's f32
    # grads of that batch, and the reference of both, the same step in
    # float64 through plain torch
    alone = world1_trainer("alone")
    alone.train()
    alone_digest = params_digest(alone.model)
    del alone
    trainer.train_step(model, opt, sched, lc, H, W, FOCAL, train_batch(), "kernel",
                       torch.Generator(device=dev).manual_seed(0))
    whole = {"params": {k: v.cpu() for k, v in model.state_dict().items()},
             "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}}
    plain = dataclasses.replace(lc, render=dataclasses.replace(lc.render, mlp_backend="torch"))
    model.load_state_dict(init)
    model.zero_grad(set_to_none=True)
    trainer.loss_fn(model, plain, H, W, FOCAL, train_batch(), "kernel")[0].backward()
    torch_grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
    model.load_state_dict(init)
    m64, lc64, b64 = trainer.float64_copy(model, lc, train_batch())
    trainer.loss_fn(m64, lc64, H, W, FOCAL, b64, "kernel")[0].backward()
    f64_grads = {n: p.grad.cpu() for n, p in m64.named_parameters() if p.grad is not None}
    del m64, b64
    torch.cuda.synchronize()
    res.update(f64_rows({"kernel": whole["grads"], "torch_f32": torch_grads}, f64_grads, "ddp"))

    # the world of 1 in a process group: the all-reduce and the striped
    # paths give the bits of no process group; its windows are timed once
    # the ranks' untimed work is done
    assert dist.initialize(f"127.0.0.1:{free_port()}", 1, 0, "0", device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl" and dist.process_count() == 1
        zero_counts(fused)
        grouped = world1_trainer("world1")
        grouped.train()
        torch.cuda.synchronize()
        res["world1_launches"] = read_counts(fused)
        res["world1_bitwise_no_group"] = params_digest(grouped.model) == alone_digest
        wait_for([out / f"untimed_done{r}" for r in range(DDP_WORLD)], "the ranks' Trainer",
                 ranks_ok)
        res["ranks_ready_s"] = time.perf_counter() - t_ranks
        res["world1_ms_per_iter"] = [ddp_window_ms(grouped, trainer) for _ in range(2)]
    finally:
        torch.distributed.destroy_process_group()
    del grouped
    res["world1_s"] = time.perf_counter() - t0

    (out / "go_timed").touch()  # their all-reduce and windows: this process waits
    wait_for([out / f"rank{r}.json" for r in range(DDP_WORLD)], "the ranks' results", ranks_ok)
    for r, p in enumerate(ranks.procs):
        assert p.wait(timeout=DDP_WAIT_S) == 0, f"rank {r} failed:\n{ranks.log(r)}"
    res["ranks_s"] = time.perf_counter() - t_ranks
    got_ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(DDP_WORLD)]
    r0 = got_ranks[0]

    # the step: bitwise across ranks, Adam's step of the all-reduced grads,
    # and those grads within the f32 step's limits of the whole batch's
    got = torch.load(out / "step_rank0.pt", weights_only=True)
    model.load_state_dict(init)
    opt, _ = trainer.make_optimizer(cfg, model)
    for n, p in model.named_parameters():
        p.grad = got["grads"][n].to(dev)
    opt.step()
    res["step_params_adam_of_grads"] = all(
        torch.equal(v.cpu(), got["params"][k]) for k, v in model.state_dict().items())
    del model, opt
    names = [n for n, g in whole["grads"].items() if g.abs().max() > 0]
    cos = {n: cosine(got["grads"][n], whole["grads"][n]) for n in names}
    control = {n: cosine(whole["grads"][n], torch_grads[n]) if n in torch_grads else 0.0
               for n in names}
    held = [n for n in names if control[n] >= GRAD_COS_MIN["float32"]]
    res["step_grad_cos_all"] = cosine(torch.cat([got["grads"][n].flatten() for n in names]),
                                      torch.cat([whole["grads"][n].flatten() for n in names]))
    res["step_grad_cos_min"] = min(cos[n] for n in held)
    res["step_grads_held"] = f"{len(held)} of {len(names)}"
    res["step_grad_cos_not_held"] = {n: [cos[n], control[n]] for n in names if n not in held}
    res["step_grad_max_rel_err_scene_mlps"] = max(
        ((got["grads"][n] - whole["grads"][n]).abs().max() / whole["grads"][n].abs().max()).item()
        for n in names if n.startswith(("mlp_coarse.", "mlp_fine.")))
    res["step_param_max_abs_err"] = max((v - whole["params"][k]).abs().max().item()
                                        for k, v in got["params"].items())
    res["step_launches_rank"] = r0["step_launches"]

    # the Trainer on each rank
    res["dataset_rays"] = [r["dataset_rays"] for r in got_ranks]
    res["local_n_rand"] = r0["local_n_rand"]
    res["launches"] = [r["launches"] for r in got_ranks]
    res["launches_per_iteration"] = r0["launches_per_iteration"]
    res["ms_per_iter_ranks"] = [r["ms_per_iter"] for r in got_ranks]
    res["allreduce_ms"] = [r["allreduce_ms"] for r in got_ranks]
    res["allreduce_mb"] = r0["allreduce_floats"] * 4 / 1e6
    res["peak_mem_gb"] = [r["peak_mem_gb"] for r in got_ranks]
    res["eval"] = r0["evals"]
    res["ranks_clock_s"] = [r["clock_s"] for r in got_ranks]  # since each took the spec
    print("  ddp: " + json.dumps(res), flush=True)
    print(f"  ddp: {DDP_WORLD} ranks on {backend} (cards {devices}"
          f"{', sharing one card' if res['shared_card'] else ''}): ms an iteration (allkernel, "
          f"{res['local_n_rand']} rays a rank) {res['ms_per_iter_ranks']} against one rank's "
          f"{res['world1_ms_per_iter']} ({TRAINER_N_RAND} rays, NCCL world of 1); all-reduce of "
          f"{res['allreduce_mb']:.2f} MB {[a['median'] for a in res['allreduce_ms']]} ms; peak "
          f"{res['peak_mem_gb']} GB a rank; the step against one process on the whole batch: "
          f"grad cosine {res['step_grad_cos_all']:.7f} over all, >= {res['step_grad_cos_min']:.7f} "
          f"on the {res['step_grads_held']} parameters held, params within "
          f"{res['step_param_max_abs_err']:.3g}; the ranks' untimed work done "
          f"{res['ranks_ready_s']:.1f} s and the ranks done {res['ranks_s']:.1f} s after the "
          f"spec", flush=True)

    assert res["world1_bitwise_no_group"], "a world of 1 changed the params' bits"
    assert all(v > 0 for k, v in res["world1_launches"].items() if k != "nerf_mlp_bwd_stash")
    assert all(r["step_digest"] == r0["step_digest"] for r in got_ranks), "ranks' steps differ"
    assert res["step_params_adam_of_grads"], "rank 0's params are not Adam's step of its grads"
    assert res["step_grad_cos_all"] >= GRAD_COS_MIN["float32"], res["step_grad_cos_all"]
    assert res["step_grad_cos_min"] >= GRAD_COS_MIN["float32"], res["step_grad_cos_min"]
    assert not any(n.startswith(("mlp_coarse.", "mlp_fine.")) for n in
                   res["step_grad_cos_not_held"]), res["step_grad_cos_not_held"]
    for r in got_ranks:
        assert not r["launches_wrong"], ("launches per iteration", r["launches_wrong"][:3])
        assert r["launches"]["nerf_mlp_fwd"] > 0 and r["launches"]["nerf_mlp_bwd_remat"] > 0
        assert r["tables_equal_single_process"] and r["rematches"] == 1
        assert r["tables_certainty_max"] > 0
        assert r["resumed_step"] == DDP_ITERS
        assert r["resumed_params_digest"] == r0["params_digest"]
        assert r["resumed_tables_digest"] == r0["tables_digest"]
        for key in ("params_digest", "tables_digest", "evals", "window_params_digest", "loss"):
            assert json.dumps(r[key]) == json.dumps(r0[key]), (r["rank"], key)
    assert ddp_expected_launches(fused, r0["local_n_rand"], False)["nerf_mlp_bwd_remat"] == 40
    assert r0["stages"][6][1] and not r0["stages"][5][1], r0["stages"]  # CTE from 7
    assert "logs/poster_lushnerf/000010.ckpt" in r0["files"], r0["files"]
    assert "logs/poster_lushnerf/match_tables_000008.npz" in r0["files"], r0["files"]
    assert all(r["files"] == [] for r in got_ranks[1:]), [r["files"] for r in got_ranks[1:]]
    assert len(r0["evals"]) == 1 and np.isfinite(r0["evals"][0]["psnr"]), r0["evals"]
    return res


def device_trace(fn, no_grad: bool = False):
    """fn once more after a warm-up call, traced by torch.profiler (the CUDA
    activity only: tracing the CPU ops slows a host-held step and takes
    seconds to read, `scripts/trace_span.py`): its span (the first CUDA
    runtime call to the last event's end), the device's busy ms (the union
    of kernel intervals) and share of the span, and the device time by
    kernel (the top 10); or a note where the profiler recorded no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.set_grad_enabled(not no_grad):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    evs = prof.events()
    # device work only: the optimizer's user annotations (Optimizer.step#...)
    # also land on the device timeline and would count twice
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("Optimizer.")]
    if not dev:
        return "not measured: the profiler recorded no device events"
    span = max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)
    busy, end = 0.0, -1.0
    for e in sorted(dev, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy += t - max(s, end)
            end = t
    by_name = {}
    for e in dev:
        key = next((k for k in ("fwd_sm90_kernel", "nerf_mlp_dgrad_sm90",
                                "nerf_mlp_bwd_dgrad_f32", "nerf_mlp_bwd_wgrad",
                                "nerf_mlp_bwd_reduce") if k in e.name),
                   e.name[:70])
        ms, n = by_name.get(key, (0.0, 0))
        by_name[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "span_ms": span / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / span,
        "kernel_ms_total": sum(ms for ms, _ in by_name.values()),
        "top_kernels": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
    }


def profile_phase(lush, cfg_mod, trainer, untraced_ms):
    """Device time by kernel and the device's busy share (the union of
    kernel intervals over the span of the traced region, and over the
    untraced wall time), from torch.profiler, over 3 forward_kernel calls,
    one render_image, one flagship train step (stash), and one step of the
    shipped scene configs (f32 remat, at their point_chunk and at 0) and of
    plain torch f32."""
    lc = flagship(cfg_mod)
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    rays, idx = flagship_batch()
    gen = torch.Generator(device="cuda").manual_seed(1)
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    batch = train_batch()

    def step_run(variant, point_chunk=None):
        cfg, tlc = train_cfg(cfg_mod, variant, point_chunk)
        tmodel = lush.LushNeRF(tlc, seed=0, device="cuda")
        opt, sched = trainer.make_optimizer(cfg, tmodel)
        return False, lambda: trainer.train_step(tmodel, opt, sched, tlc, H, W, FOCAL, batch,
                                                 "kernel", gen)

    runs = {
        "forward_kernel_x3": (True, lambda: [lush.forward_kernel(model, lc, H, W, FOCAL, rays, idx, gen)
                                             for _ in range(3)]),
        "render_image": (True, lambda: lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)),
        "train_step": step_run("stash"),
        "train_step_remat_f32": step_run("remat_f32"),
        "train_step_remat_f32@0": step_run("remat_f32", 0),
        "train_step_torch_f32": step_run("torch"),
    }
    res = {}
    for name, (no_grad, fn) in runs.items():
        res[name] = device_trace(fn, no_grad)
        if isinstance(res[name], dict) and untraced_ms.get(name):
            res[name]["untraced_ms"] = untraced_ms[name]
            res[name]["device_busy_share_of_untraced"] = (res[name]["device_busy_ms"]
                                                          / untraced_ms[name])
    print("  " + json.dumps(res), flush=True)
    return res


def held_bf16(got, want, f32) -> dict:
    """bf16 kernel output against its plain version as phase 3 holds it:
    KERNEL_TOL per value, and the mean error at most BF16_MEAN_ERR_SHARE of
    the mean gap between the plain version in f32 (f32) and in bf16."""
    err = (got - want).abs()
    tol = KERNEL_TOL["bfloat16"]
    r = {"max_abs_err": err.max().item(),
         "mean_err_over_f32_gap": err.mean().item() / (f32 - want).abs().mean().item(),
         "finite": bool(torch.isfinite(got).all())}
    r["within_tol"] = ((err - tol["atol"] - tol["rtol"] * want.abs()).max().item() <= 0
                       and r["mean_err_over_f32_gap"] <= BF16_MEAN_ERR_SHARE and r["finite"])
    return r


def pe_bound_ms(P: int) -> tuple:
    """K4: xd read (32 B) and the PE row written (512 B) per point, against
    its trig work at the f32 rate."""
    t_bytes = P * (32 + 512) / PEAK_BYTES * 1e3
    t_ops = P * PE_TRIG_OPS / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tune_phase(fused, pe_mm, tune, NeRFMLP, MLPConfig):
    """The kernel-cost path at TUNE_P (its times are the K1 split), then on
    the script's xd and MLP: K1 and K3 (remat, on g = 2 out as the script's
    sum(out^2) gives it) against their plain versions, K4 and K5 against
    theirs, and K5(K4(xd)) against K1."""
    zero_counts(fused)
    zero_counts(pe_mm, PE_MM_COUNTERS)
    printed = tune.main(device="cuda", P=TUNE_P)
    torch.cuda.synchronize()
    res = {"script_s_per_call": {k: v for k, v in printed.items() if k not in ("device", "P")},
           "launches": {**read_counts(pe_mm, PE_MM_COUNTERS), **read_counts(fused)}}
    print("  launches: " + json.dumps(res["launches"]), flush=True)

    # the script's model and points
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    xd_all = torch.from_numpy(
        np.random.default_rng(0).standard_normal((TUNE_P, fused.XD_CH)).astype(np.float32)).cuda()
    with torch.no_grad():
        # K1 and K3 at the script's P, as phases 3 and 4 hold them: the plain
        # backward reads K1's stash (K3 recomputes the same bits), since on its
        # own recomputed activations a few relu masks differ by a sum order,
        # which moves d(xd) through the PE's 2^9 factor (a diagnostic below)
        out = fused.nerf_mlp_fwd(mlp, xd_all, "bfloat16")
        out_p, acts_p = fused.nerf_mlp_fwd_plain(mlp, xd_all, "bfloat16", with_acts=True)
        k1 = {f"k1_{k}": v for k, v in held_bf16(
            out, out_p, fused.nerf_mlp_fwd_plain(mlp, xd_all, "float32")).items()}
        del out_p
        acts_k = fused._launch_fwd(mlp, xd_all, "bfloat16", 10, 4, stash=True)[1]
        g = 2 * out
        k3 = flat_grads(fused.nerf_mlp_bwd(mlp, xd_all, g, "bfloat16"))
        torch.cuda.synchronize()
        f32 = flat_grads(fused.nerf_mlp_bwd_plain(mlp, xd_all, g, "float32"))
        k3_row = held_bwd(k3, flat_grads(fused.nerf_mlp_bwd_plain(
            mlp, xd_all, g, "bfloat16", acts=acts_k)), f32, "bfloat16", "k3")
        k3_row["k3_finite"] = all(bool(torch.isfinite(t).all()) for t in k3)
        own = held_bwd(k3, flat_grads(fused.nerf_mlp_bwd_plain(
            mlp, xd_all, g, "bfloat16", acts=acts_p)), f32, "bfloat16", "own")
        relu = slice(0, 8 * MLP_WIDTH)
        k3_row["diag_relu_mask_flips_vs_own_recompute"] = int(
            ((acts_k[:, relu] > 0) != (acts_p[:, relu] > 0)).sum())
        k3_row["diag_vs_own_recompute"] = {k: v for k, v in own.items() if not k.endswith("tol")}
        del out, g, k3, f32, acts_k, acts_p
        torch.cuda.empty_cache()
    res["k1_k3"] = {"P": TUNE_P, **k1, **k3_row}
    print("  " + json.dumps(res["k1_k3"]), flush=True)
    if not (k1["k1_within_tol"] and k3_row["k3_within_tol"] and k3_row["k3_finite"]):
        raise AssertionError(f"K1 / K3 disagree with their plain versions: {res['k1_k3']}")

    rows = []
    with torch.no_grad():
        for label, P in (("tune", TUNE_P), ("ragged", 4096 * 64 + 37)):
            xd = xd_all[:P]
            row = {"shape": label, "P": P}
            pe = pe_mm.pe_only(xd)
            pe_p = pe_mm.pe_only_plain(xd)
            torch.cuda.synchronize()
            row["pe_max_abs_err"] = (pe - pe_p).abs().max().item()
            row["pe_lanes_90_128_zero"] = not bool(pe[:, 90:].any())
            row["pe_within_tol"] = (row["pe_max_abs_err"] <= PE_TOL and row["pe_lanes_90_128_zero"]
                                    and bool(torch.isfinite(pe).all()))
            mm = pe_mm.mm_only(mlp, pe)
            torch.cuda.synchronize()
            want = pe_mm.mm_only_plain(mlp, pe, "bfloat16")
            f32 = pe_mm.mm_only_plain(mlp, pe, "float32")
            row.update({f"mm_{k}": v for k, v in held_bf16(mm[:, :3], want[:, :3], f32[:, :3]).items()})
            row["mm_lanes_3_128_zero"] = not bool(mm[:, 3:].any())
            del want, f32
            # K5(K4(xd)) against K1: lane 0 = rgb0 + alpha, lanes 1, 2 = rgb1, rgb2
            def lanes(raw):
                return torch.stack([raw[:, 0] + raw[:, 3], raw[:, 1], raw[:, 2]], 1)
            k1_out = lanes(fused.nerf_mlp_fwd(mlp, xd, "bfloat16"))
            k1_f32 = lanes(fused.nerf_mlp_fwd_plain(mlp, xd, "float32"))
            torch.cuda.synchronize()
            row.update({f"split_vs_k1_{k}": v
                        for k, v in held_bf16(mm[:, :3], k1_out, k1_f32).items()})
            del k1_out, k1_f32
            if label == "tune":
                # the kernels' times are the script's two-length differences
                row["pe_ms"] = printed["pe_only"][0] * 1e3
                row["pe_plain_ms"] = time_ms(lambda: pe_mm.pe_only_plain(xd), 3, 1)
                row["pe_bound_ms"], row["pe_bound_by"] = pe_bound_ms(P)
                row["mm_ms"] = printed["mm_only"][0] * 1e3
                row["mm_plain_ms"] = time_ms(lambda: pe_mm.mm_only_plain(mlp, pe, "bfloat16"), 3, 1)
                w_bytes = sum(t.numel() * t.element_size() for t in fused.pack_params(mlp, "bfloat16"))
                row["mm_bound_ms"], row["mm_bound_by"] = bound_ms(P, w_bytes, True, 1, 1024)
                row["k1_ms"] = printed["fwd"][0] * 1e3
                row["split_pe_share_of_k1"] = row["pe_ms"] / row["k1_ms"]
                row["split_mm_share_of_k1"] = row["mm_ms"] / row["k1_ms"]
                print(f"  K1 split at P = {P}: PE-only {row['pe_ms']:.3f} ms + matmul-only "
                      f"{row['mm_ms']:.3f} ms = {row['pe_ms'] + row['mm_ms']:.3f} ms against K1 "
                      f"{row['k1_ms']:.3f} ms", flush=True)
            del pe, pe_p, mm
            torch.cuda.empty_cache()
            print("  " + json.dumps(row), flush=True)
            rows.append(row)
            ok = (row["pe_within_tol"] and row["mm_within_tol"] and row["mm_lanes_3_128_zero"]
                  and row["split_vs_k1_within_tol"])
            if not ok:
                raise AssertionError(f"PE-only / matmul-only kernels disagree: {row}")
    res["rows"] = rows
    res["pe_rows"] = pe_rows(pe_mm, xd_all)
    from lushnerf_torch.scripts import pe_ablate  # builds K4 with parts compiled out
    res["pe_ablation"] = {r["variant"]: r["ms"] for r in pe_ablate.main(TUNE_P)}
    print(f"  K4 at P = {TUNE_P}: " + json.dumps(res["pe_ablation"])
          + f" ms (full, sines replaced by their arguments, stores removed); bound "
          f"{pe_bound_ms(TUNE_P)[0]:.4f} ms ({pe_bound_ms(TUNE_P)[1]})", flush=True)
    launched = res["launches"]
    if launched["pe_only"] <= 0 or launched["mm_only"] <= 0 or launched["nerf_mlp_fwd"] <= 0 \
            or launched["nerf_mlp_bwd_remat"] <= 0:
        raise AssertionError(f"the tune path did not launch every kernel: {launched}")
    return res


def pe_rows(pe_mm, xd_all) -> list:
    """K4 alone against its plain version at one point, at a P that is not
    a whole number of its 64-point tiles, and on points with |x| up to 1e3
    in all six lanes (angles 2^9 x past sinf's fast range reduction, which
    the tune path's standard-normal points never reach): PE_TOL, lanes
    90:128 exactly 0."""
    rows = []
    big = torch.from_numpy(np.random.default_rng(5).uniform(-1e3, 1e3, (65_536, 8))
                           .astype(np.float32)).cuda()
    big[:, 6:] = 0
    for label, xd in (("one", xd_all[:1]), ("odd_tile", xd_all[:100_003]), ("large_x", big)):
        with torch.no_grad():
            pe = pe_mm.pe_only(xd)
            pe_p = pe_mm.pe_only_plain(xd)
        torch.cuda.synchronize()
        row = {"shape": label, "P": xd.shape[0], "pe_max_abs_err": (pe - pe_p).abs().max().item(),
               "pe_lanes_90_128_zero": not bool(pe[:, 90:].any()),
               "largest_angle": xd[:, :6].abs().max().item() * 2 ** 9}
        row["pe_within_tol"] = (row["pe_max_abs_err"] <= PE_TOL and row["pe_lanes_90_128_zero"]
                                and bool(torch.isfinite(pe).all()))
        print("  K4 " + json.dumps(row), flush=True)
        rows.append(row)
        if not row["pe_within_tol"]:
            raise AssertionError(f"the PE-only kernel disagrees with its plain version: {row}")
    return rows


RETIMED = ("raymajor_excl_cumsum", "raymajor_transpose", "raymajor_masked_dists")
RETIME_WINDOWS = 7  # device windows of each function at each retime shape
# the renderer's rays x samples and the JAX probe's T x S, with the cumsum's
# channels (1 as sample_pdf runs it, 8 as probes P1 and P1b do)
RETIME_SHAPES = {"coarse": (5120, 64, 1), "fine": (5120, 128, 1), "probe": (16, 64, 8)}


def probe_retime(raymajor, gen):
    """K6/K7, K8 and K10 against Tensor.clone of the same bytes and against
    the launch floor (Tensor.clone of 16 bytes), with the plain versions and
    the PyTorch calls of K6/K7 and K10, RETIME_WINDOWS windows each, taken in turns, at
    RETIME_SHAPES.  Returns K8's rows in their earlier form and every
    shape's: spreads, each kernel's median less the clone's of its bytes
    and over it, and its bound."""
    transpose, rows = [], []
    for label, (R, S, c) in RETIME_SHAPES.items():
        n = R * S
        w = torch.rand((R, S, c), generator=gen, device="cuda") + 1e-3
        x = (w / w.sum(1, keepdim=True)).reshape(n, c)  # a pdf over each ray's samples
        v = torch.rand((n, 1), generator=gen, device="cuda")
        z = torch.sort(torch.rand((R, S), generator=gen, device="cuda"), -1).values.reshape(n, 1)
        tiny = torch.rand(4, generator=gen, device="cuda")
        fns = {
            "raymajor_excl_cumsum": lambda: raymajor.excl_cumsum(x, S),
            "raymajor_transpose": lambda: raymajor.ray_transpose(v, S),
            "raymajor_masked_dists": lambda: raymajor.masked_dists(z, S),
            "excl_cumsum_plain": lambda: raymajor.excl_cumsum_plain(x, S),
            "masked_dists_plain": lambda: raymajor.masked_dists_plain(z, S),
            "torch_cumsum": lambda: torch.cumsum(x.view(R, S, c) if c > 1 else x.view(R, S), 1),
            "torch_diff": lambda: torch.diff(z.view(R, S), dim=1, append=z.view(R, S)[:, -1:]),
            "clone": lambda: v.clone(), "floor": lambda: tiny.clone()}
        if c > 1:
            fns["clone_cumsum_bytes"] = lambda: x.clone()
        times = dict(zip(fns, device_windows(list(fns.values()), repeats=RETIME_WINDOWS)))
        r = {"shape": label, "rays": R, "samples": S, "cumsum_channels": c,
             **{name: spread(ms) for name, ms in times.items()}}
        for name in RETIMED:
            clone = r["clone_cumsum_bytes" if c > 1 and name == "raymajor_excl_cumsum"
                      else "clone"]["median"]
            nbytes = 2 * 4 * n * (c if name == "raymajor_excl_cumsum" else 1)
            r[f"{name}_bound_ms"] = nbytes / PEAK_BYTES * 1e3
            r[f"{name}_minus_clone_median_ms"] = r[name]["median"] - clone
            r[f"{name}_over_clone"] = r[name]["median"] / clone
        r["clone_minus_floor_median_ms"] = r["clone"]["median"] - r["floor"]["median"]
        print("  retime " + json.dumps(r), flush=True)
        rows.append(r)
        if label in RAY_SHAPES:
            k8 = {"shape": label, "rays": R, "samples": S, "kernel": r["raymajor_transpose"],
                  "clone": r["clone"]}
            k8["kernel_minus_clone_median_ms"] = k8["kernel"]["median"] - r["clone"]["median"]
            k8["slower_than_clone_beyond_spread"] = k8["kernel"]["p25"] > k8["clone"]["p75"]
            transpose.append(k8)
    return transpose, rows


def probe_cases(raymajor, gen):
    """K6/K7 at CUMSUM_CASES on per-ray pdfs (each channel's over S sums to
    1) and K10 at DISTS_CASES on sorted rays: against the plain versions
    and the PyTorch calls (the cumsum within CUMSUM_TOL, its first samples
    exactly 0; the dists bit for bit), each call twice bitwise, and the
    64-bit index arithmetic bitwise the 32-bit one."""
    cumsum, dists = [], []
    for T, S, c in CUMSUM_CASES:
        w = torch.rand((T, S, c), generator=gen, device="cuda") + 1e-3
        x = (w / w.sum(1, keepdim=True)).reshape(T * S, c)
        got = raymajor.excl_cumsum(x, S)
        lib = torch.cumsum(x.view(T, S, c), 1) - x.view(T, S, c)
        r = {"rays": T, "samples": S, "channels": c,
             "plan": raymajor.cumsum_plan(S, c),
             "max_abs_err": (got - raymajor.excl_cumsum_plain(x, S)).abs().max().item(),
             "library_max_abs_err": (got.view(T, S, c) - lib).abs().max().item(),
             "first_samples_zero": bool((got.view(T, S, c)[:, 0] == 0).all()),
             "repeat_bitwise": torch.equal(got, raymajor.excl_cumsum(x, S)),
             "index64_bitwise": torch.equal(got, raymajor.excl_cumsum(x, S, wide=True))}
        print("  cumsum " + json.dumps(r), flush=True)
        cumsum.append(r)
        if not (max(r["max_abs_err"], r["library_max_abs_err"]) <= CUMSUM_TOL
                and r["first_samples_zero"] and r["repeat_bitwise"] and r["index64_bitwise"]):
            raise AssertionError(f"raymajor_excl_cumsum disagrees: {r}")
    for T, S in DISTS_CASES:
        z = torch.sort(torch.rand((T, S), generator=gen, device="cuda") * 5, -1).values
        z = z.reshape(T * S, 1)
        got = raymajor.masked_dists(z, S)
        zz = z.view(T, S)
        lib = torch.diff(zz, dim=1, append=zz[:, -1:]).reshape(-1, 1)
        r = {"rays": T, "samples": S, "tail": T * S % 4,
             "bitwise": torch.equal(got, raymajor.masked_dists_plain(z, S)),
             "library_bitwise": torch.equal(got, lib),
             "repeat_bitwise": torch.equal(got, raymajor.masked_dists(z, S)),
             "index64_bitwise": torch.equal(got, raymajor.masked_dists(z, S, wide=True))}
        print("  dists " + json.dumps(r), flush=True)
        dists.append(r)
        if not all(v for k, v in r.items() if k.endswith("bitwise")):
            raise AssertionError(f"raymajor_masked_dists disagrees: {r}")
    return cumsum, dists


def probe_phase(raymajor, probe):
    """The five probes (launches counted), then each kernel at the
    renderer's per-ray shapes against its plain version, with device times
    of the kernel, the plain version and the PyTorch call."""
    zero_counts(raymajor, RAYMAJOR_COUNTERS)
    results = probe.main(device="cuda")
    torch.cuda.synchronize()
    res = {"probes": dict(results), "launches": read_counts(raymajor, RAYMAJOR_COUNTERS)}
    print("  launches: " + json.dumps(res["launches"]), flush=True)
    if not all(ok for _, ok in results):
        raise AssertionError(f"probes failed: {[n for n, ok in results if not ok]}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32_bytes = 4
    rows = []
    for label, (R, S) in RAY_SHAPES.items():
        n = R * S
        w = torch.rand((R, S), generator=gen, device="cuda")
        pdf = (w / w.sum(-1, keepdim=True)).reshape(n, 1)  # sample_pdf's per-ray pdf
        v = torch.rand((n, 1), generator=gen, device="cuda")
        cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)  # sorted per ray
        u = torch.rand((n, 1), generator=gen, device="cuda")
        z = torch.sort(torch.rand((R, S), generator=gen, device="cuda"), -1).values.reshape(n, 1)
        cases = {
            "raymajor_excl_cumsum": (
                lambda: raymajor.excl_cumsum(pdf, S), lambda: raymajor.excl_cumsum_plain(pdf, S),
                lambda: torch.cumsum(pdf.view(R, S), 1), CUMSUM_TOL, 2 * n * f32_bytes, n),
            "raymajor_transpose": (
                lambda: raymajor.ray_transpose(v, S), lambda: raymajor.ray_transpose_plain(v, S),
                lambda: v.clone(), 0.0, 2 * n * f32_bytes, 0),
            "raymajor_searchsorted": (
                lambda: raymajor.searchsorted_count(cdf, u),
                lambda: raymajor.searchsorted_count_plain(cdf, u),
                lambda: torch.searchsorted(cdf, u.view(R, S), right=True), 0.0,
                (n + 2 * n) * f32_bytes, n * S),
            "raymajor_masked_dists": (
                lambda: raymajor.masked_dists(z, S), lambda: raymajor.masked_dists_plain(z, S),
                lambda: torch.diff(z.view(R, S), dim=1, append=z.view(R, S)[:, -1:]), 0.0,
                2 * n * f32_bytes, n),
        }
        for name, (kern, plain, library, tol, nbytes, ops) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            row = {"kernel": name, "shape": label, "rays": R, "samples": S, "max_abs_err": err,
                   "repeat_bitwise": torch.equal(got, kern())}
            row["within_tol"] = (err <= tol and bool(torch.isfinite(got).all())
                                 and row["repeat_bitwise"])
            if library is not None:  # the PyTorch call gives the same values
                lib = library()
                if name == "raymajor_excl_cumsum":  # inclusive: shift to exclusive
                    lib = torch.cat([torch.zeros_like(lib[:, :1]), lib[:, :-1]], 1)
                row["library_max_abs_err"] = (got.reshape(lib.shape) - lib.float()).abs().max().item()
                row["within_tol"] &= row["library_max_abs_err"] <= tol
            row["ms"] = device_ms(kern)
            row["plain_ms"] = device_ms(plain)
            row["library_ms"] = device_ms(library) if library is not None else None
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = ops / PEAK_F32_FLOPS * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            print("  " + json.dumps(row), flush=True)
            rows.append(row)
            if not row["within_tol"]:
                raise AssertionError(f"{name} disagrees with its plain version: {row}")
    res["rows"] = rows
    res["transpose_retime"], res["retime"] = probe_retime(raymajor, gen)
    res["cumsum_cases"], res["dists_cases"] = probe_cases(raymajor, gen)
    # K8 exactly on lengths with a tail (n % 4 = 1, 3) and on one element
    res["transpose_cases"] = []
    for R, S in ((517, 37), (5, 7), (1, 1)):
        v = torch.rand((R * S, 1), generator=gen, device="cuda")
        r = {"rays": R, "samples": S, "bitwise": bool(torch.equal(
            raymajor.ray_transpose(v, S), raymajor.ray_transpose_plain(v, S)))}
        print("  transpose " + json.dumps(r), flush=True)
        res["transpose_cases"].append(r)
        if not r["bitwise"]:
            raise AssertionError(f"raymajor_transpose disagrees: {r}")
    # K9 on rows torch.searchsorted does not take (unsorted, with ties: the
    # kernel's count path, timed at the renderer's shapes), and on a ragged S
    # and SI, unsorted and sorted with ties (its binary-search path; also
    # against torch.searchsorted)
    res["searchsorted_cases"] = []
    for label, (R, S, SI) in (("unsorted_ties", (5120, 128, 128)),
                              ("unsorted_ties_coarse", (5120, 64, 64)),
                              ("ragged_unsorted", (517, 37, 45)), ("ragged", (517, 37, 45))):
        cdf = torch.randint(0, 16, (R, S), generator=gen, device="cuda").float() / 16
        if label == "ragged":
            cdf = cdf.sort(-1).values
        u = torch.randint(0, 17, (R * SI, 1), generator=gen, device="cuda").float() / 16
        got = raymajor.searchsorted_count(cdf, u)
        r = {"case": label, "rays": R, "samples": S, "si": SI,
             "max_abs_err": (got - raymajor.searchsorted_count_plain(cdf, u)).abs().max().item()}
        if label == "ragged":
            lib = torch.searchsorted(cdf, u.view(R, SI), right=True).float().reshape(-1, 1)
            r["library_max_abs_err"] = (got - lib).abs().max().item()
        elif R == 5120:
            r["ms"] = device_ms(lambda: raymajor.searchsorted_count(cdf, u))
        print("  searchsorted " + json.dumps(r), flush=True)
        res["searchsorted_cases"].append(r)
        if r["max_abs_err"] != 0 or r.get("library_max_abs_err", 0) != 0:
            raise AssertionError(f"raymajor_searchsorted disagrees: {r}")
    return res


def kernel_entries(results):
    """The `kernels` line: each kernel with its main-path launches (the
    forward_kernel, render_image, train_step, pe, tonemap, cte and ddp
    phases; the cte and ddp phases' also apart, the ddp phase's by rank too;
    the pe phase's path in `pe_entry`), its largest error against its plain
    version, and its times at the flagship fine P in bf16."""
    fwd_rows = results.get("kernel") or []
    bwd_rows = [r for r in results.get("kernel_bwd") or []
                if r["shape"] not in ("large_activation", "tiny_cotangent")]
    fine = next((r for r in bwd_rows if r["dtype"] == "bfloat16" and r["shape"] == "fine"), None)
    if fine is None:
        return []
    train = results.get("train_step") or {}
    cte = (results.get("cte") or {}).get("launches_total", {})
    tonemap = (results.get("tonemap") or {}).get("launches_total", {})
    ddp = results.get("ddp") or {}
    ddp_ranks = ddp.get("launches", [])  # each rank's Trainer run
    ddp_counts = {k: ddp.get("world1_launches", {}).get(k, 0)
                  + ddp.get("step_launches_rank", {}).get(k, 0) * len(ddp_ranks)
                  + sum(r.get(k, 0) for r in ddp_ranks) for k in COUNTERS}
    pe = results.get("pe") or {}
    pe_counts = pe.get("launches", {})
    counts = {k: v + cte.get(k, 0) + tonemap.get(k, 0) + ddp_counts[k] + pe_counts.get(k, 0)
              for k, v in train.get("launches_total", {}).items()}
    fwd_launches = counts.get("nerf_mlp_fwd", 0) + sum(
        results.get(p, {}).get("launches", 0) for p in ("forward_kernel", "render_image"))
    timed = [r for r in bwd_rows if "stash_ms" in r]

    def entry(name, source, replaces, launches, err, prefix, extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "path": "main", "launches": launches, "max_abs_err": err, "ms": fine[f"{prefix}_ms"],
                "plain_ms": fine[f"{prefix}_plain_ms"], "bound_ms": fine[f"{prefix}_bound_ms"],
                "bound_by": fine[f"{prefix}_bound_by"], "library_ms": None, **extra}

    shapes = lambda prefix: [  # noqa: E731
        {"dtype": r["dtype"], "P": r["P"], "ms": r[f"{prefix}_ms"],
         "plain_ms": r[f"{prefix}_plain_ms"], "bound_ms": r[f"{prefix}_bound_ms"]} for r in timed]
    bwd_err = max(r[f"{p}_max_abs_err"] for r in bwd_rows for p in ("bwd", "bwd_on_plain_stash"))
    bwd_rel = max(r[f"{p}_max_rel_err"] for r in bwd_rows for p in ("bwd", "bwd_on_plain_stash"))
    tune = (results.get("tune_kernel") or {}).get("k1_k3", {})

    def at_tune_p(prefix):
        """K1's or K3's errors against its plain version at the tune path's P."""
        return {f"tune_path_{k}": tune[f"{prefix}_{k}"] for k in ("max_abs_err", "max_rel_err")
                if f"{prefix}_{k}" in tune}
    return [
        entry("nerf_mlp_fwd", "lushnerf_torch/csrc/nerf_mlp_fwd.cu",
              "lushnerf_tpu/ops/fused/nerf_mlp.py:396", fwd_launches,
              max([r["max_abs_err"] for r in fwd_rows] + [r["fwd_out_max_abs_err"] for r in bwd_rows]),
              "fwd_stash",
              {**at_tune_p("k1"), **pe_entry(pe, 256, ("float32", "bfloat16"), "fwd"),
               "launches_cte": cte.get("nerf_mlp_fwd", 0),
               "launches_tonemap": tonemap.get("nerf_mlp_fwd", 0),
               "launches_ddp": ddp_counts["nerf_mlp_fwd"],
               "launches_ddp_ranks": [r.get("nerf_mlp_fwd", 0) for r in ddp_ranks],
               "shapes_stash": shapes("fwd_stash"),
               "shapes_output_only": [{k: r[k] for k in ("dtype", "P", "ms", "plain_ms", "bound_ms",
                                                         "max_abs_err") if k in r} for r in fwd_rows]}),
        entry("nerf_mlp_bwd_stash", "lushnerf_torch/csrc/nerf_mlp_dgrad.cu",
              "lushnerf_tpu/ops/fused/nerf_mlp.py:608", counts.get("nerf_mlp_bwd_stash", 0),
              bwd_err, "stash", {"max_rel_err": bwd_rel, "shapes": shapes("stash"),
                                 **pe_entry(pe, 256, ("float32", "bfloat16"), "stash"),
                                 "also_source": "lushnerf_torch/csrc/nerf_mlp_bwd.cu",
                                 "launches_are": "dgrad + wgrad + 2 reductions per point chunk",
                                 **bwd_split(bwd_rows)}),
        entry("nerf_mlp_bwd_remat", "lushnerf_torch/csrc/nerf_mlp_dgrad.cu",
              "lushnerf_tpu/ops/fused/nerf_mlp.py:589", counts.get("nerf_mlp_bwd_remat", 0),
              bwd_err, "remat", {"max_rel_err": bwd_rel, **at_tune_p("k3"), "shapes": shapes("remat"),
                                 **pe_entry(pe, 256, ("float32", "bfloat16"), "remat"),
                                 "launches_cte": cte.get("nerf_mlp_bwd_remat", 0),
                                 "launches_tonemap": tonemap.get("nerf_mlp_bwd_remat", 0),
                                 "launches_ddp": ddp_counts["nerf_mlp_bwd_remat"],
                                 "launches_ddp_ranks": [r.get("nerf_mlp_bwd_remat", 0)
                                                        for r in ddp_ranks],
                                 "also_source": "lushnerf_torch/csrc/nerf_mlp_fwd.cu, nerf_mlp_bwd.cu",
                                 "launches_are": "K1 with its stash + dgrad + wgrad + 2 "
                                                 "reductions per point chunk"}),
    ] + width128_entries(results.get("width128"), pe) + tune_entries(results.get("tune_kernel")) \
        + probe_entries(results.get("probe_raymajor"))


def pe_entry(pe, width: int, dtypes, kernel: str) -> dict:
    """What a kernel's entry says of the pe phase: the PEs of PE_GEOS it
    ran at this width in these dtypes (each held against its plain version
    there), its largest error over them, its launches on the pe phase's
    path (width 256: the Trainer, its eval view, the bf16 render), and at
    width 256 its times at PE_TIMED (`kernel`: fwd, stash or remat)."""
    rows = [r for r in pe.get("checks", []) if r["width"] == width and r["dtype"] in dtypes]
    if not rows:
        return {}
    err = "fwd_out_max_abs_err" if kernel == "fwd" else "bwd_max_abs_err"
    out = {"new_pe_geometries": sorted({r["pe"] for r in rows}),
           "new_pe_max_abs_err": max(r[err] for r in rows)}
    if kernel != "fwd":  # the PEs with a part of 128 channels: the dgrads' own build
        out["new_pe_max_rel_err"] = max(r["bwd_max_rel_err"] for r in rows)
        out["new_pe_also_source"] = f"lushnerf_torch/csrc/{WIDE_PE_CSRC}"
    if width == 256:
        name = {"fwd": "nerf_mlp_fwd", "stash": "nerf_mlp_bwd_stash",
                "remat": "nerf_mlp_bwd_remat"}[kernel]
        out["launches_pe_path"] = pe.get("launches", {}).get(name, 0)
        out["new_pe_timed"] = [{k: r[k] for k in ("pe", "dtype", "P", f"{kernel}_ms",
                                                  f"{kernel}_bound_ms") + (
            ("fwd_stash_ms", "fwd_pe_work_share_of_tile") if kernel == "fwd" else ()) if k in r}
            for r in pe.get("timed", []) if r["dtype"] in dtypes]
    return out


def width128_entries(w128, pe=None):
    """The width-128 builds of K1 and of the backward (its dgrad and wgrad;
    K3 is K1 with its stash and them), in f32 and in bf16, on the width128
    phase's main path (f32: its f32 step, Trainer run and eval view; bf16:
    its two bf16 steps and its render): launches there by dtype, errors
    over the phase's rows of the dtype, times at the fine P."""
    if not w128:
        return []
    out = []
    for dtype, names in (("float32", ("nerf_mlp_fwd@w128", "nerf_mlp_bwd_remat@w128")),
                         ("bfloat16", ("nerf_mlp_fwd_bf16@w128", "nerf_mlp_bwd_bf16@w128"))):
        fwd_rows = [r for r in w128["kernel"] if r["dtype"] == dtype]
        bwd = [r for r in w128["kernel_bwd"] if r["dtype"] == dtype]
        fine = next(r for r in bwd if r["shape"] == "fine")
        counts = w128["launches"][dtype]
        timed = [r for r in bwd if "stash_ms" in r]

        def entry(name, source, replaces, launches, err, prefix, extra):
            return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "path": "main (width 128)", "width": W128, "dtype": dtype,
                    "launches": launches, "max_abs_err": err, "ms": fine[f"{prefix}_ms"],
                    "plain_ms": fine[f"{prefix}_plain_ms"], "bound_ms": fine[f"{prefix}_bound_ms"],
                    "bound_by": fine[f"{prefix}_bound_by"], "library_ms": None, "P": fine["P"],
                    **extra}

        bwd_extra = {
            "max_rel_err": max(r[f"{p}_max_rel_err"] for r in bwd
                               for p in ("bwd", "bwd_on_plain_stash")),
            "also_source": "lushnerf_torch/csrc/nerf_mlp_fwd.cu, nerf_mlp_bwd.cu",
            "shapes": [{"P": r["P"], "ms": r["remat_ms"], "plain_ms": r["remat_plain_ms"],
                        "bound_ms": r["remat_bound_ms"], "stash_ms": r["stash_ms"],
                        "stash_plain_ms": r["stash_plain_ms"],
                        "stash_bound_ms": r["stash_bound_ms"]} for r in timed],
            **bwd_split(bwd)}
        bwd_err = max(r[f"{p}_max_abs_err"] for r in bwd for p in ("bwd", "bwd_on_plain_stash"))
        bwd_extra.update(pe_entry(pe or {}, W128, (dtype,), "remat"))
        if dtype == "float32":  # the shipped configs' remat: K3 f32
            bwd_entry = entry(names[1], "lushnerf_torch/csrc/nerf_mlp_dgrad.cu",
                              "lushnerf_tpu/ops/fused/nerf_mlp.py:589",
                              counts["nerf_mlp_bwd_remat"], bwd_err, "remat",
                              {**bwd_extra, "launches_are": "K1 with its stash + dgrad + wgrad + "
                                                            "2 reductions per point chunk"})
        else:  # the flagship's stash (K2) and the shipped configs' remat (K3) in bf16
            bwd_entry = entry(names[1], "lushnerf_torch/csrc/nerf_mlp_dgrad.cu",
                              "lushnerf_tpu/ops/fused/nerf_mlp.py:608",
                              counts["nerf_mlp_bwd_stash"] + counts["nerf_mlp_bwd_remat"],
                              bwd_err, "stash",
                              {**bwd_extra, "also_replaces": "lushnerf_tpu/ops/fused/nerf_mlp.py:589",
                               "launches_stash": counts["nerf_mlp_bwd_stash"],
                               "launches_remat": counts["nerf_mlp_bwd_remat"],
                               "launches_are": "dgrad + wgrad + 2 reductions per point chunk "
                                               "(remat: K1 with its stash first)"})
        out += [
            entry(names[0], "lushnerf_torch/csrc/nerf_mlp_fwd.cu",
                  "lushnerf_tpu/ops/fused/nerf_mlp.py:396", counts["nerf_mlp_fwd"],
                  max([r["max_abs_err"] for r in fwd_rows] + [r["fwd_out_max_abs_err"] for r in bwd]),
                  "fwd_stash",
                  {**pe_entry(pe or {}, W128, (dtype,), "fwd"),
                   "stash_max_rel_err": max(r["stash_max_rel_err"] for r in bwd),
                   "shapes_stash": [{"P": r["P"], "ms": r["fwd_stash_ms"],
                                     "plain_ms": r["fwd_stash_plain_ms"],
                                     "bound_ms": r["fwd_stash_bound_ms"]} for r in timed],
                   "shapes_output_only": [{k: r[k] for k in ("P", "ms", "plain_ms", "bound_ms",
                                                             "max_abs_err") if k in r}
                                          for r in fwd_rows]}),
            bwd_entry]
    return out


def bwd_split(bwd_rows) -> dict:
    """K2's dgrad and its wgrad with the reductions, timed apart in both
    dtypes at both flagship P, the dgrad's and the wgrad's stage shares at
    the fine P, and the bf16 wgrad's error on its own scratch at every P."""
    rows = [r for r in bwd_rows if "dgrad_ms" in r]
    out = {"split": [{k: r[k] for k in ("dtype", "P", "dgrad_ms", "dgrad_bound_ms", "dgrad_bound_by",
                                        "wgrad_ms", "wgrad_bound_ms", "wgrad_bound_by",
                                        "wgrad_torch_mm_12_calls_ms")}
                     for r in rows]}
    for r in rows:
        if "dgrad_stages" in r:
            out[f"dgrad_stage_share_{r['dtype']}"] = r["dgrad_stages"]["group_share"]
        if "wgrad_stages" in r:
            out[f"wgrad_consumer_share_{r['dtype']}"] = r["wgrad_stages"]["consumer_share"]
    out["bf16_wgrad_alone_max_rel_err"] = {r["P"]: r["wgrad_alone_max_rel_err"]
                                            for r in bwd_rows if "wgrad_alone_max_rel_err" in r}
    return out


def tune_entries(tune):
    """K4 and K5 on the tune path: launches while it ran, errors over both
    shapes, times at TUNE_P."""
    if not tune:
        return []
    rows = tune["rows"]
    t = next(r for r in rows if r["shape"] == "tune")

    def entry(name, replaces, prefix, extra):
        return {"name": name, "route": "cuda", "source": "lushnerf_torch/csrc/nerf_pe_mm.cu",
                "replaces": replaces, "path": "tune_kernel",
                "launches": tune["launches"][name],
                "max_abs_err": max(r[f"{prefix}_max_abs_err"] for r in rows),
                "ms": t[f"{prefix}_ms"], "plain_ms": t[f"{prefix}_plain_ms"],
                "bound_ms": t[f"{prefix}_bound_ms"], "bound_by": t[f"{prefix}_bound_by"],
                "library_ms": None, "P": t["P"], **extra}

    return [
        entry("pe_only", "scripts/tune_kernel.py:100", "pe", {
            "max_abs_err_all_rows": max(r["pe_max_abs_err"] for r in rows + tune["pe_rows"]),
            "ablation_ms": tune["pe_ablation"]}),
        entry("mm_only", "scripts/tune_kernel.py:119", "mm", {
            "mean_err_over_f32_gap": max(r["mm_mean_err_over_f32_gap"] for r in rows),
            "split_vs_k1_max_abs_err": max(r["split_vs_k1_max_abs_err"] for r in rows),
            "k1_ms": t["k1_ms"]}),
    ]


PROBE_REPLACES = {  # kernel -> the JAX probe kernels it replaces
    "raymajor_excl_cumsum": ["scripts/probe_raymajor_mosaic.py:56",
                             "scripts/probe_raymajor_mosaic.py:87"],
    "raymajor_transpose": ["scripts/probe_raymajor_mosaic.py:125"],
    "raymajor_searchsorted": ["scripts/probe_raymajor_mosaic.py:153"],
    "raymajor_masked_dists": ["scripts/probe_raymajor_mosaic.py:181"],
}


def probe_entries(probe):
    """K6-K10 on the probe path: launches of the five probes, errors over
    the renderer's shapes, times at 5120 x 64 (both shapes under `shapes`);
    K6/K7, K8 and K10 also their RETIME_WINDOWS-window medians beside Tensor.clone of
    the same bytes and the launch floor (`retime`)."""
    if not probe:
        return []
    out = []
    for name, replaces in PROBE_REPLACES.items():
        rows = [r for r in probe["rows"] if r["kernel"] == name]
        r = next(r for r in rows if r["shape"] == "coarse")
        out.append({
            "name": name, "route": "cuda", "source": "lushnerf_torch/csrc/raymajor_probe.cu",
            "replaces": replaces[0], "path": "probe_raymajor",
            "launches": probe["launches"][name],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "also_replaces": replaces[1:],
            "shapes": [{k: x[k] for k in ("rays", "samples", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "max_abs_err")} for x in rows]})
        if name in RETIMED:  # the retime windows beside Tensor.clone and the launch floor
            out[-1]["retime"] = [
                {"rays": t["rays"], "samples": t["samples"], "ms": t[name]["median"],
                 "over_clone": t[f"{name}_over_clone"], "floor_ms": t["floor"]["median"],
                 "bound_ms": t[f"{name}_bound_ms"]} for t in probe["retime"]]
        if name == "raymajor_excl_cumsum":
            out[-1]["cases_max_abs_err"] = max(x["max_abs_err"] for x in probe["cumsum_cases"])
    return out


def print_build_logs(logs: dict) -> None:
    """Each build's registers, spills, entries and wall time, and ptxas's
    performance notes by code."""
    for name, log in logs.items():
        notes = {}  # ptxas performance notes (wgmma fences, serialisation) by code
        for line in log.splitlines():
            code = re.search(r"\((C7\d\d\d)\)", line)
            if code:
                if code.group(1) not in notes:
                    print(f"  {name}: {line.strip()[:240]}")
                notes[code.group(1)] = notes.get(code.group(1), 0) + 1
            elif any(k in line for k in ("registers", "spill", "Compiling entry", "wall time")):
                print(f"  {name}: {line.strip()}")
        if notes:
            print(f"  {name}: ptxas notes by code: {json.dumps(notes)}")


class BuildRest:
    """The builds that phases 3 to 7 do not launch (the MLP's sources at
    width 128, the dgrads for a PE part of 128 channels, the tune and probe
    paths' and the tune phase's K4 variants), in two processes at the
    lowest CPU priority (nice 19, their nvcc processes too), so that they
    take the cores this script's one busy thread leaves idle while phases 3
    to 7 run the width-256 kernels on the card.  wait() returns their nvcc
    output, or raises with it."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory(prefix="chip_smoke_build_")
        self.procs = []

    def start(self, items):
        out = Path(self.dir.name)
        cmds = {"build": ["-m", "lushnerf_torch.ops.fused.build", "--json",
                          str(out / "logs.json"), *items],
                "pe_ablate": ["-m", "lushnerf_torch.scripts.pe_ablate", "--build_only"]}
        for name, args in cmds.items():
            log = open(out / f"{name}.log", "w")
            self.procs.append((name, log, subprocess.Popen(
                [sys.executable, *args], stdout=log, stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent, preexec_fn=lambda: os.nice(19))))

    def wait(self) -> dict:
        out = Path(self.dir.name)
        for name, log, proc in self.procs:
            if proc.wait() != 0:
                log.flush()
                raise RuntimeError(f"{name} failed:\n{(out / f'{name}.log').read_text()[-6000:]}")
        logs = json.loads((out / "logs.json").read_text())
        logs["pe_ablate"] = (out / "pe_ablate.log").read_text()
        return logs

    def close(self):
        for _, log, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
        self.dir.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write all results to this JSON file")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the build (a partial run: it "
                         "prints no kernels or result line)")
    ap.add_argument("--ddp_worker", nargs=2, metavar=("DIR", "RANK"),
                    help="run one rank of the ddp phase (the script starts them)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    if args.ddp_worker:
        return ddp_worker(args.ddp_worker[0], int(args.ddp_worker[1]))
    try:
        from lushnerf_torch import config as cfg_mod
        from lushnerf_torch.models import lushnerf as lush
        from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
        from lushnerf_torch.ops.fused import build
        from lushnerf_torch.ops.fused import nerf_mlp as fused
        from lushnerf_torch.ops.fused import pe_mm, raymajor
        from lushnerf_torch.scripts import probe_raymajor, tune_kernel
        from lushnerf_torch.train import trainer
    except ImportError as e:
        print(f"chip_smoke: the lushnerf_torch package is not here ({e})", file=sys.stderr)
        return 2
    # the plain versions are the reference: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    rest = BuildRest()

    def do_build():
        # the MLP's three sources at width 256, which phases 3 to 7 launch,
        # one nvcc process each, while this thread takes the import that
        # train_step would pay for; then the other builds start niced
        # beside those phases (`BuildRest`)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as pool:
            kernels = pool.submit(build.build_all, [(src, 256) for src in fused.SOURCES]
                                  + [fused.PACK_SOURCE])
            t0 = time.perf_counter()
            torch.optim.Adam([torch.zeros(1, requires_grad=True)])  # imports torch._dynamo
            print(f"  the first Adam, while nvcc runs: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            logs = kernels.result()
        print_build_logs(logs)
        rest.start([f"{src}@w{W128}" for src in fused.SOURCES]
                   + [f"{fused.WIDE_PE_SOURCE}@w{w}" for w in (256, W128)]
                   + ["nerf_pe_mm", "raymajor_probe"])
        return logs

    def do_build_rest():
        logs = rest.wait()
        print_build_logs(logs)
        return logs

    def untraced():
        train = smoke.results.get("train_step") or {}
        fk = smoke.results.get("forward_kernel") or {}
        ri = smoke.results.get("render_image") or {}
        return {"forward_kernel_x3": 3 * fk["ms_per_call"] if fk else None,
                "render_image": ri.get("ms_per_image"),
                "train_step": (train.get("stash") or {}).get("ms_per_step"),
                "train_step_remat_f32": (train.get("remat_f32") or {}).get("ms_per_step"),
                "train_step_remat_f32@0": (train.get("remat_f32@0") or {}).get("ms_per_step"),
                "train_step_torch_f32": (train.get("torch") or {}).get("ms_per_step")}

    runs = {
        "build": do_build,
        "kernel": lambda: kernel_phase(fused, NeRFMLP, MLPConfig),
        "kernel_bwd": lambda: kernel_bwd_phase(fused, NeRFMLP, MLPConfig),
        "forward_kernel": lambda: forward_phase(fused, lush, cfg_mod),
        "render_image": lambda: render_phase(fused, lush, cfg_mod),
        "train_step": lambda: train_phase(fused, lush, cfg_mod, trainer),
        "pack": lambda: pack_phase(fused, cfg_mod, trainer, NeRFMLP, MLPConfig),
        "build_rest": do_build_rest,
        "width128": lambda: width128_phase(fused, lush, cfg_mod, trainer, NeRFMLP, MLPConfig,
                                           smoke.results),
        "pe": lambda: pe_phase(fused, lush, cfg_mod, trainer, NeRFMLP, MLPConfig),
        "tonemap": lambda: tonemap_phase(fused, lush, cfg_mod, trainer),
        "trainer": lambda: trainer_phase(fused, cfg_mod, trainer),
        "cte": lambda: cte_phase(fused, cfg_mod, trainer),
        "dkm": lambda: dkm_phase((smoke.results.get("cte") or {}).pop("views", None)),
        "ddp": lambda: ddp_phase(fused, cfg_mod, trainer, ranks),
        "profile": lambda: profile_phase(lush, cfg_mod, trainer, untraced()),
        "tune_kernel": lambda: tune_phase(fused, pe_mm, tune_kernel, NeRFMLP, MLPConfig),
        "probe_raymajor": lambda: probe_phase(raymajor, probe_raymajor),
    }
    only = set(filter(None, args.only.split(",")))
    # the ddp phase's processes, started first: their imports overlap the build
    ranks = DdpRanks() if not only or "ddp" in only else None
    try:
        for name, run in runs.items():
            if not {"build", "build_rest"} & set(smoke.failed) \
                    and (not only or name in ("build", "build_rest") or name in only):
                smoke.phase(name, run)
    finally:
        rest.close()
        if ranks is not None:
            ranks.close()
    (smoke.results.get("cte") or {}).pop("views", None)  # arrays, not results
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in smoke.seconds.items()})
          + f", total {sum(smoke.seconds.values()):.1f}; the script "
          f"{time.perf_counter() - T_IMPORTED:.1f} s after importing torch", flush=True)
    if only:
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "failed": smoke.failed, "seconds": smoke.seconds,
                           "results": smoke.results}, f, indent=1, default=str)
        print(f"chip_smoke: partial run of {sorted(only)}; failed: {smoke.failed}", flush=True)
        return 1 if smoke.failed else 0

    kernels = kernel_entries(smoke.results)
    if not smoke.failed:
        idle = [k["name"] for k in kernels if k["launches"] <= 0]
        if len(kernels) != 13 or idle:
            print(f"chip_smoke: kernels not launched on their path: {idle} "
                  f"({len(kernels)} of 13 listed)", file=sys.stderr)
            smoke.failed.append("kernels")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "failed": smoke.failed, "seconds": smoke.seconds, "results": smoke.results,
                       "kernels": kernels},
                      f, indent=1, default=str)
    if smoke.failed:
        print(f"chip_smoke: FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
