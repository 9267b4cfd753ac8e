#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time the CUDA kernels,
serve depth4 DispNet at 576x384 with the committed teacher weights, train config 4
(depth10_flow, joint depth + optical flow) at 224x480, train config 2 (depth4, supervised
depth with in-loop validation) at 240x720, train both phases of split_training
(DepthPoseNet pairwise, then depth4 over [coarse depth | image]) at 192x256, train config 3
(the full-resolution DepthPoseNet, self-supervised depth and pose) at 192x256, run the eval
harness's two nets, serve DepthPoseNet pairs, run the int8 / bf16 tensor-core probes,
serve TurboDepthNet, train TurboDepthNet on config 2 (``depth_only --turbo``) and by
distillation from the depth4 teacher, serve from checkpoint directories, gather from a
device-resident corpus, train the DeMoN-stream families at 192x256: config 5 (the
truncated DepthPoseNet, ``on_demon``) and the symmetric L/R family (``LRNet``,
``depth_then_cam_lr`` with and without ``--gt_pose``), and train the colon-pair families:
``optflow_family``'s five modes on DispNet depth4 and sfm at 224x480, and ``dim11`` on the
full-resolution DepthPoseNet at 224x224, refine depth4 DispNet's weights on one pair
against a COLMAP model at 224x224 (``infer/refine_cli.py``), serve the flow-augmented
DepthPoseNet at 192x256, train config 2 data-parallel over NCCL at world size 1 with the
multi-device dry run, train through the C++ loader, write the rich summaries and a
profiler trace, and serve TF1-imported weights.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: nvcc -> shared library -> ctypes for every kernel, one nvcc per source, all
     started together, with nvcc's wall times and the -Xptxas -v lines;
  3. kernel vs plain: ``fused_tail`` against ``fused_tail_reference`` at the tail's shapes
     of a 576x384 batch of 8, 16 and 64 (at 16 and 64 each persistent bf16 block takes
     several items), teacher weights, seeded inputs, in float32 and bf16;
  4. whole forward: ``fast_depth_forward`` in float32 with the fused tail against the
     plain module forward (``DispNet`` eval, native tail) at rtol = atol = 2e-4;
  5. serving, a main path: a ``DepthPredictor`` answers requests of 8, 5 and 1 frames;
     the kernels' launch counts are set to 0 just before and read just after;
  6. times with CUDA events: the tail kernel, its plain version, its bound and the native
     chain of the same layers (``infer/fast.py:native_tail``, cuDNN; a yardstick of several
     calls) at batch 8 and 64, and the bf16 forward's frames/s at batch 64;
  7. kernel vs plain: ``bilinear_sample_group`` on a config-4 step's 12 warps (B=10,
     224x480 down to 28x60, pixels in [0, 255], a GT, a predicted-depth and a flow warp of
     each scale's image; dcoords on the 8 that need them): one launch each way, out and
     wmask bit-equal to the plain version, dcoords within the limit of autograd of the
     plain version and the same bits twice; then ``bilinear_sample`` (a group of one) at
     scale 0 with the coords of a real depth warp (with dimgs), wild coords, exact-integer
     coords and an odd non-square size: the forward bit-equal, dcoords and dimgs within
     the limit;
  8. training, a main path: the config-4 CLI (``train/experiments/optflow_combine.py``,
     bf16, batch 10, 240x720 JPEG pairs read and resized to 224x480) on a synthetic
     dataset for 5 steps, with the launch counts set to 0 before and read after (one
     forward and one backward sampler launch for the step's 12 warps, no plain sampling,
     and one forward and one backward smoothness launch, for its 12 maps, a step); every
     loss component finite; the checkpoint read back into ``DispNet(depth10_flow)`` and
     its eval forward finite;
  9. step parity: one float32 step with the kernels against one with the plain sampler
     and smoothness term from one init and batch, and the bf16 step's loss against the
     float32 one;
 10. times (``tools/sampler_units.py``): a config-4 step's 12 warps three ways (one group
     call, the same kernels once a warp, the plain version) and ``grid_sample``, forward
     and forward + backward, each twice in turns, beside the bound, with each way's device
     time; the sampler kernels' device time in a config-4 step (``profile_step``); ms/step
     and frames/s of the bf16 training step with the kernels and with the plain sampler;
 11. kernel vs plain: the smoothness kernels (forward and backward) against the plain
     term, on single maps (``smoothness_fused``, a group of one) at config 2's four scales
     (B=10, 240x720 down to 30x90), on a strided C=1 flow plane of an NCHW [B, 2, H, W]
     head, a constant and a piecewise-constant map (exact ties) and an odd 37x53 map, and
     on whole steps' groups (``smoothness_fused_group``: config 4's 12 maps, config 2's
     4, optflow3's 12 channel views of its 3-channel heads and optflow_only's 8 flow
     planes at 224x480, NCHW heads viewed NHWC, at their coefficients; optflow3's total
     also against the f64 term of the 3-channel maps): the forward within rtol 1e-5 of
     the float32 and the float64 plain term, the backward within 1e-6 max|g| of autograd
     of the plain term, and the same bits in two runs;
 12. training, a main path: the config-2 CLI (``train/experiments/depth_only.py``, bf16,
     batch 10, 240x720) on the same dataset for 5 steps with ``--validation_check 2``,
     the launch counts set to 0 before and read after (one forward and one backward
     smoothness launch a step, one forward a validation); every train and val
     record finite; the checkpoint read back into ``DispNet(depth4)``;
 13. times: the smoothness kernels and the plain term beside the bound, forward and
     forward + backward, at config 2's scale 0 and over a step's group in configs 2 and
     4, each group three ways (one group call, the same kernels called once a map, and
     the plain term), each way twice in turns; the kernels' device time in a config-4 step (``profile_step``);
     ms/step of the bf16 config-2 step with the kernels and with the plain term, in turns;
 14. kernel vs plain: the sig kernels (forward, and backward for pred and gt) against
     the plain composition (``ops/sig.py``), on single pairs (``sig_l2_fused``, a group
     of one) at phase 2's four scales (B=1, 192x256 down
     to 24x32, delta 2), the 5-delta ``full_scales`` call at 192x256 (B=1 and B=8), the
     eval harness's calls at B=16 (phase 20's shapes: the pair net's 5-delta call at
     192x256, the single net's delta-2 calls at four scales), a coarse map where the
     deltas reach past the map, an odd 37x53 map and a strided C=1 plane: the forward
     within rtol 1e-5 of the float32 and the float64 plain version, the backward within
     1e-6 of autograd of the plain version and equal, bit for bit, to
     ``sig_l2_backward_reference``, and the same bits in two runs; and on whole steps'
     groups (``sig_l2_fused_group``: phase 2's 4 pairs, phase 1's 2, the single net's
     eval batch) at a coefficient, to the same limits, the gather formula taken at it;
 15. training, two main paths: split_training's phase 1 (the truncated DepthPoseNet
     pairwise) and phase 2 (depth4 DispNet over [coarse depth | image]), bf16, batch 1,
     192x256, 5 steps each through ``train_pair`` and ``train_single``, the functions the
     CLI's ``main`` calls, with the launch counts set to 0 before each phase and read
     after it (one forward and one backward sig launch a step, for the pairs of scales 2
     and 3 in phase 1 and of all four in phase 2); every loss component finite; both checkpoint groups read back into
     ``DepthPoseNet`` and a 4-channel ``DispNet(depth4)`` with finite eval forwards;
 16. step parity: one float32 step of each phase with the kernel against one with the
     plain sig composition from one init and batch, and the bf16 step's loss against the
     float32 one;
 17. times: the sig kernels and the plain composition beside the bound, forward and
     forward + backward, over phase 2's four pairs of a step three ways (one group call,
     the same kernels called once a pair, the plain composition; each twice in turns) and
     at the 5-delta
     192x256 B=8 call; ms/step of each phase's bf16 step with the kernel and with the
     plain version, in turns; and launches, device time and the sig kernels' device time
     a step of each phase from ``train/profile_step.py``.
 18. kernel vs plain: ``bilinear_sample_fused_group`` on a config-3 step's 4 warps (B=16,
     192x256 down to 24x32, C=3, the coords of a real Euler warp; dcoords and dimgs): one
     launch each way; then ``bilinear_sample_fused`` (a group of one) on each of those,
     a 16x24 image at 24x16 coords, taps past every border, NaN and infinite coords, and
     B=10 (outside JAX's rule: the launches go to the sampler's own route): out and wmask
     bit-equal (their largest difference printed and reported), dcoords and dimgs within
     bilinear_sample's limit of autograd of the plain version, the same bits twice;
 19. training, a main path: config 3 (``train/experiments/depth_then_cam.py``, the
     full-resolution DepthPoseNet, bf16, batch 16, 192x256) for 5 steps through the CLI's
     ``train``, the launch counts read before each batch is taken (each step one forward
     and one backward fused sampler launch for the 4 scales' warps, one forward and one
     backward smoothness launch for the 4 scales, no launch on the sampler's own route and
     no plain sampling); every loss component finite; the checkpoint read back;
 20. evaluation, two main paths: the eval harness's ``--net pair`` (config 3's checkpoint
     as the pair net) and ``--net single`` through its functions on 2 batches of 16 at
     192x256, the sig launches counted (one a batch for either net);
 21. serving, two main paths: ``PairPredictor`` (bf16, the folded forward of
     ``infer/fast_pose.py``) on 16 pairs at 192x256 from config 3's full-resolution
     checkpoint, and from split_training's truncated phase-1 checkpoint (the net
     ``infer/cli.py --mode pair`` serves), each against the f32 module forward at phase
     5's limits; frames/s;
 22. step parity and times: one f32 config-3 step with the kernels against one with the
     plain sampler and smoothness term, and the bf16 loss against the f32 one; a config-3
     step's 4 warps three ways (one group call, the same kernels once a warp, the plain
     version) and ``grid_sample`` beside the bound, forward and forward + backward, each
     twice in turns (``tools/sampler_units.py``); ms/step of the bf16 step with the fused
     and with the plain sampler, in turns of 5 steps; launches and the sampler kernels'
     device time a step from ``train/profile_step.py``.
 23. kernel vs plain: ``cuobjdump -sass`` on the built ``dot_loop``, ``dot_grid``,
     ``fused_tail``, ``smoothness``, ``sig_l2`` and ``bilinear_sample`` libraries, with
     each kernel's HGMMA, IGMMA, UTMALDG, UTMASTG, HMMA and IMMA counts and its registers
     and spills (raising unless the probes' bf16 products run on HGMMA and the int8 ones on
     IGMMA, each loading through UTMALDG, with no HMMA or IMMA left, and unless the tail's
     bf16 kernel holds HGMMA and UTMALDG and no HMMA; its f32 kernel and the loss and
     sampler kernels are listed, not held); then
     ``dot_loop`` (1024^3, R = 64) and ``dot_grid`` (4096^3) against their plain versions
     on the probes' operands, int8 and bf16: int8 bit-equal, bf16 within
     ``bf16_rtol(K)`` of max |plain|, the probes' float32 sums likewise, one product
     launch a call, a transpose of B before each int8 one and the loop's sum of its K
     parts after it; a shape off the tile raises;
 24. the probes, two main paths: ``tools/probe_int8_dot.py`` and
     ``tools/probe_int8_dot2.py`` of the port run as a user runs them, the launch counts
     set to 0 before and read after (2 x 41 launches of each kernel, 41 transposes of B
     each, 82 sums of the loop's parts); then times: each kernel alone (CUDA events, best
     of 5 windows), its TOPS and share of the bound, the plain version, the library
     yardstick (``torch._int_mm``, ``torch.mm`` with float32 output; R in turn for the
     loop), the call as the JAX probes time it (kernel, float32 sum, ``.item()``) and the
     int8 / bf16 speed-ups; beside them ``torch._int_mm`` with B column-major, another
     layout than the probes';
 25. turbo forward parity: ``fast_turbo_forward`` against the module's eval ``full_only``
     forward for the nine presets, B=2, float32 (colon at 240x720, the others at
     576x384) at rtol = atol = 2e-4, on the committed weights where the machine has them
     and a seeded init with set batch statistics elsewhere;
 26. serving, a main path: a ``TurboPredictor`` (bf16, folded) over the committed
     turbo-small weights answers requests of 8, 5 and 1 frames at 576x384 within phase
     5's limits of the f32 module forward, with no kernel of this package on the path;
     frames/s of the bf16 folded forward at B=128 (CUDA events) and of the predictor from
     uint8 host frames;
 27. serving, a main path (after phase 12, on its checkpoint): ``infer/cli.py --mode
     depth --checkpoint_dir`` over 12 JPEGs at 240x720, B=8, one ``fused_tail`` launch a
     batch (2) and no other launch;
 28. training, a main path: ``depth_only --turbo colon`` (bf16, B=10, 240x720, the same
     dataset) for 5 steps with a validation every 2, the counts set to 0 before and read
     after (one forward and one backward smoothness launch a step, one forward a
     validation, nothing else); every record finite; then its ``model`` checkpoint served
     by ``infer/cli.py --mode turbo --checkpoint_group model --turbo_variant colon``;
 29. training, a main path: distillation (``distill_turbo.py``'s ``main``, bf16, B=8,
     576x384, turbo-base, the committed teacher as ``model-0.npz`` of a teacher directory)
     for 5 steps with a validation every 2, the counts set to 0 before and read after:
     exactly one ``fused_tail`` launch a step and one a validation (5 + 2), nothing else;
     every record finite; ``turbo-5.npz`` read back into the student, eval forward
     finite; then served by ``infer/cli.py --mode turbo --checkpoint_dir``;
 30. step parity and times: one f32 distill step with the teacher's fused tail against
     one with the native tail from one init and batch (loss components within 1e-4, the
     parameters as phase 9), the bf16 step's total against the f32 one; ms/step of the
     bf16 distill step and of the teacher's forward in it (fused and native tails; CUDA
     events, two turns);
 31. serving, a main path: ``DepthPredictor(use_fast=False)``, the bf16 module forward,
     answers requests of 8, 5 and 1 frames at 576x384 within phase 5's limits, with no
     launch; then a ``DeviceCache`` of 64 uint8 frames at 576x384 (42 MB) gathered at B=8
     with mirror and rot180 bits, bit-equal to numpy's gather, and the gather timed;
 32. kernel vs plain: ``bilinear_sample_group`` on an L/R step's 16 samplings (B=16,
     192x256 down to 24x32; at each scale both images, C=3, and both inverse depths, C=1,
     at the coords of real angle-axis warps; dcoords on all 16, dimgs on the 8 C=1
     members): one launch each way, out and wmask bit-equal, dcoords and dimgs within
     TOL_DCOORDS of autograd of the plain version, dcoords the same bits twice; then the
     group both ways and the plain version, in turns (each coords tensor shared by two
     members, as in a step), with the group's device time where its profiler session kept
     all its kernels, beside the bound;
 33. training, a main path: config 5 (``train/experiments/on_demon.py``, the truncated
     DepthPoseNet, bf16, batch 16, 192x256) for 5 steps through the CLI's ``train``, the
     launch counts read before each batch is taken (each step one forward and one backward
     smoothness launch for disp3 and disp4, and nothing else); every loss component
     finite; ``model-5.npz`` read back into the truncated DepthPoseNet and served by
     ``PairPredictor`` as in phase 21 (no launch);
 34. training, two main paths: ``train/experiments/depth_then_cam_lr.py`` (``LRNet``, bf16,
     batch 16, 192x256) for 5 steps in each mode, counts per step as in phase 33: full
     mode one forward and one backward launch of the sampler (16 samplings) and of
     smoothness (16 maps); ``--gt_pose`` the same (8 maps) and one of sig each way (the
     5-delta term at 192x256); no plain sampling, nothing else; every loss component
     finite; each checkpoint read back into ``LRNet`` with a finite eval forward;
 35. step parity: one f32 step of each L/R mode with the kernels against one with the plain
     sampler, smoothness and sig terms from one init and batch (phase 9's limits), and
     the bf16 total against the f32 one;
 36. times: ms/step of the bf16 config-5, ``lr_full`` and ``lr_gt`` steps with the kernels,
     with every term plain and (L/R) with the plain sampler and the loss kernels, in
     turns of 5 steps (the ways in order, then reversed), the L/R steps' share of
     sampled pixels outside their source image; launches, device time by kind and busy
     share a step of each from ``train/profile_step.py``, kernels and plain; a device
     time whose profiler session lost some of its kernels is not measured and left out
     of the ``kernels`` line;
 37. training, six main paths: a colon-pair dataset (240x720 JPEG pairs) and a
     dim11-layout one (224x224, 6-value cam files, the depths in a directory of their
     own); ``optflow_family`` in each of its five modes (bf16, batch 10, resized to
     224x480) and ``dim11`` (the full-resolution DepthPoseNet, bf16, batch 10, 224x224)
     for 5 steps each through the CLIs' ``train`` and ``batches``, the launch counts read
     before each batch is taken: one forward and one backward smoothness launch a step in
     every mode, its group 4 C=1 maps (only_image, pre, dim11), 8 flow planes
     (optflow_only) or the 12 channel views of 3-channel heads (optflow3, sfm), all
     eligible; one forward and one backward sampler launch a step in only_image,
     optflow_only and dim11 and no plain sampling; in sfm (JAX's "xla" preset) its 4
     forward-only warps as plain samplings; nothing else; every loss component finite; each checkpoint read
     back into its model with a finite eval forward; then the sfm checkpoint served by
     ``DepthPredictor(variant=sfm)`` through the module forward, with no launch;
 38. step parity: one f32 step of optflow_only, of optflow3 (224x480) and of dim11
     (224x224, pixels in [-0.5, 0.5]; B=10) with the kernels against one with the plain
     sampler and smoothness term from one init and batch (phase 9's limits), and the bf16
     total against the f32 one (phase 11 holds optflow3's 12-view and optflow_only's
     8-plane groups to the plain term);
 39. times: ms/step of the bf16 only_image and dim11 steps (the presets the port moves
     to ``"pallas"``) and sfm (which keeps ``"xla"``) with ``sampler="pallas"`` and
     ``"xla"``, in 8 rounds of 5 steps each way, the first way alternating, with each
     round's paired difference and their median; each one's launches, busy share and the
     smoothness and (on a "pallas" preset) the sampler kernels' device time a step from
     ``profile_step``;
 40. refinement, a main path: ``infer/refine_cli.py`` for 20 f32 steps on a two-view
     COLMAP text model of one synthetic scene at 224x224 (known depth and pose, 64
     anchors projected from the depth; depth4 DispNet, B=1), the counts set to 0 just
     before and read after each step: 1 + 1 smoothness launches a step (a group of the 4
     disparities), and on the "pallas" preset 1 + 1 sampler launches (the 4 warps) with
     no plain sampling, on "xla" 4 plain samplings; the ``.bin`` finite, positive and of
     H x W, the scale finite and > 0;
 41. step parity: one f32 refine step with the kernels against one with the plain
     sampler and smoothness term from one init (phase 9's limits);
 42. times: ms/step of the f32 refine step with ``sampler="pallas"`` and ``"xla"`` in 8
     rounds of 5 steps each way, the first way alternating, with the paired differences
     and their median (the preset's rule); each route's launches, busy share and the
     kernels' device time a step from ``profile_step``'s ``refine`` config;
 43. flow-augmented serving, a main path: ``FlowAugmentedPredictor`` (the truncated
     DepthPoseNet over 11 channels, a seeded init warmed on the inputs) answers requests
     of 16, 5 and 1 inputs at 192x256 in bf16 through the folded forward, within phase
     5's limits of the f32 module forward; frames/s by CUDA events; no launch.
 44. data parallelism, three main paths: the default process group over NCCL at world
     size 1 (a ``FileStore``); 5 bf16 data-parallel config-2 steps at 240x720, B=10 (the
     synced batch norm, the averaged gradients and metrics of ``parallel/dp.py``), counted
     per step: 1 + 1 smoothness launches, and under the profiler at least one NCCL
     all-reduce kernel a step; one f32 data-parallel step against the single-process
     step from one init and batch (loss rel 1e-6, params within 2 lr), and the pair again
     computed in float64 (Adam's first moments, the gradients, within 1e-5 of each
     parameter's largest); the dry run's three phases (``parallel/dryrun.py:run_phases``):
     3 pairwise steps with sig 1 + 1 each, a distill step with one ``fused_tail`` launch,
     the checkpoint round trip (weights and Adam's state bit-equal); then each of those
     sig group calls (B=2, 32x64 .. 4x8) and the f32 fused tail (B=2, 64x96) held against
     its plain version on the inputs the dry run gave it;
 45. the sharded predictor: ``DepthPredictor(num_devices=1)`` answers as the default,
     bit for bit; ``num_devices`` above the card count raises;
 46. the C++ loader, a main path: ``native/fastloader.cc`` built with g++ (its seconds
     printed), its samples within the CPU test's limits of the NumPy dataset, then
     ``depth_only --native_loader`` for 5 bf16 steps at 240x720 (1 + 1 smoothness a
     step); left out, and said so, only where the loader cannot build;
 47. the summaries and the profiler hook, two main paths: split_training's phase 1 with
     ``--rich_summaries --tensorboard`` and ``depth_only --rich_summaries``, 5 steps each
     at the CLIs' defaults with ``--image_summary_freq 2`` (sig 1 + 1 and smoothness
     1 + 1 a step), their event files holding the JAX package's scalar, image and
     histogram tags where the tensorboard package is installed, else the "tensorboard
     writer unavailable" line; then ``run_training(profile_dir=...)`` on config 2, whose
     one trace names the smoothness kernels;
 48. the TF1 importer, a main path: seeded arrays under the reference's slim names
     through ``import_tf1_variables`` into depth4 DispNet, served by ``DepthPredictor``
     at 576x384, B=8 (one ``fused_tail`` launch), bit-equal to serving the same variables
     directly.
The GPU machine has no ``h5py``, so the smoke cannot write the DeMoN HDF5 files that the
split_training, depth_then_cam, on_demon and depth_then_cam_lr CLIs read
(``data/demon.py``): phases 15, 19, 33 and 34 feed the CLIs' train functions batches of
synthetic scenes, augmented and preprocessed by
``data/demon.py``'s own ``augment`` and ``preprocess``; the CPU tests run the CLIs on an
HDF5 file. The colon-pair CLIs read JPEGs, so phase 37 runs them on files.
The line before the last is one JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. There is no CPU path: without CUDA it exits non-zero.
TF32 is off throughout, so the float32 checks are float32 and not TF32.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tf_depth_estimation_torch.data import native
from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.data.device_cache import DeviceCache
from tf_depth_estimation_torch.data.pipeline import BatchLoader, to_device
from tf_depth_estimation_torch.data.synthetic import (
    colmap_pair_scene,
    make_pair_scene,
    write_colmap_pair,
    write_colon_pair_dataset,
)
from tf_depth_estimation_torch.geometry.warp import projective_inverse_warp
from tf_depth_estimation_torch.infer import cli as infer_cli
from tf_depth_estimation_torch.infer import fast as infer_fast
from tf_depth_estimation_torch.infer import refine, refine_cli
from tf_depth_estimation_torch.infer.fast import (
    fast_depth_forward,
    fold_weights,
    folded_forward,
    native_tail,
)
from tf_depth_estimation_torch.infer.fast_turbo import (
    fast_turbo_forward,
    fold_turbo,
    folded_turbo_forward,
)
from tf_depth_estimation_torch.infer.predictor import (
    DepthPredictor,
    FlowAugmentedPredictor,
    PairPredictor,
    TurboPredictor,
)
from tf_depth_estimation_torch.losses import pipelines
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet
from tf_depth_estimation_torch.models.dispnet import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.layers import SlimBatchNorm
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.ops import _build
from tf_depth_estimation_torch.ops.bilinear_sample import (
    bilinear_sample,
    bilinear_sample_group,
    bilinear_sample_reference,
    plain_group,
)
from tf_depth_estimation_torch.ops.bilinear_sample_fused import (
    bilinear_sample_fused,
    bilinear_sample_fused_group,
)
from tf_depth_estimation_torch.ops.dot_grid import TILE as DOT_GRID_TILE
from tf_depth_estimation_torch.ops.dot_grid import dot_grid, dot_grid_reference
from tf_depth_estimation_torch.ops.dot_loop import TILE as DOT_LOOP_TILE
from tf_depth_estimation_torch.ops.dot_loop import dot_loop, dot_loop_reference
from tf_depth_estimation_torch.ops.fused_tail import (
    N_PARAMS,
    fused_tail,
    fused_tail_reference,
)
from tf_depth_estimation_torch.ops.schedules import exponential_decay
from tf_depth_estimation_torch.parallel import dryrun, init_process_group, make_dp_step
from tf_depth_estimation_torch.parallel.dp import moment_gap
from tf_depth_estimation_torch.ops.sig import sig_l2_plain
from tf_depth_estimation_torch.ops.sig_l2 import (
    sig_l2_backward_reference,
    sig_l2_fused,
    sig_l2_fused_group,
    sig_l2_plain_group,
)
from tf_depth_estimation_torch.ops.smoothness import (
    second_order_smoothness,
    smoothness_backward_reference,
    smoothness_fused,
    smoothness_fused_group,
    smoothness_plain_group,
)
from tf_depth_estimation_torch.tools import probe_int8_dot, probe_int8_dot2, sampler_units
from tf_depth_estimation_torch.tools.common import inputs as probe_inputs
from tf_depth_estimation_torch.tools.common import library_product, time_2arg
from tf_depth_estimation_torch.train import profile_step
from tf_depth_estimation_torch.train import tf1_import
from tf_depth_estimation_torch.train.distill import folded_teacher, make_distill_step
from tf_depth_estimation_torch.train.experiments import (
    depth_only,
    depth_then_cam,
    depth_then_cam_lr,
    dim11,
    distill_turbo,
    eval_harness,
    on_demon,
    optflow_combine,
    optflow_family,
    split_training,
)
from tf_depth_estimation_torch.train.loop import MetricLogger, run_training
from tf_depth_estimation_torch.train.profile_step import demon_batch, plain_sig, plain_smoothness
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import (
    make_depth_only_step,
    make_depth_then_cam_step,
    make_optflow_combine_step,
    make_pairwise_step,
    make_single_depth_step,
)
from tf_depth_estimation_torch.utils.npz import load_variables_npz, save_variables_npz
from tf_depth_estimation_torch.weights import (
    depth_pose_from_variables,
    dispnet_from_variables,
    lrnet_from_variables,
    module_variables,
    turbo_from_variables,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
TEACHER = os.path.join(ROOT, "weights", "depth4_teacher_576x384.npz")
HEIGHT, WIDTH = 384, 576
SEED = 0
# fused_tail vs its plain version, (max, mean) abs error; the limits of
# tests/test_torch_fused_tail.py. float32: the same products summed in another order over
# 153 + 144 terms. bf16: the intermediates are rounded to bf16 (1/256 relative) at two
# points, and a different f32 sum can round a value to the neighbouring bf16 number; a
# kernel that skipped the rounding points would miss the mean limit.
TOL_TAIL = {torch.float32: (2e-5, 1e-6), torch.bfloat16: (1e-2, 1e-4)}
TOL_FORWARD = 2e-4  # rtol = atol of tests/test_fast_infer.py
# the bf16 serving forward against the float32 module forward, (max, mean) abs error: bf16
# activations and weights through 31 convolutions, on disparities in [0, 4]. An H100 run
# of this script measured max 9.0e-3 and mean 2.23e-3 at 576x384; the limits allow about
# 2.5x that.
TOL_SERVING = (2.5e-2, 5e-3)
# config 4, the training path (train/experiments/optflow_combine.py defaults): 240x720
# JPEG pairs read and resized to 224x480, batch 10, bf16
C4_HEIGHT, C4_WIDTH, C4_READ, C4_BATCH, C4_STEPS = 224, 480, (240, 720), 10, 5
# sampler launches (forward, backward) a config-4 step: one group call for its 12 warps (3
# warps, GT depth, predicted depth and flow, at each of 4 scales; the backward for the 8
# with dcoords)
SAMPLER_PER_STEP = (1, 1)
# the sampler kernels vs the plain version: the kernels round every product and sum on
# their own in the reference's order (__fmul_rn / __fadd_rn), as PyTorch's elementwise ops
# do, so out and wmask are bit-equal. dcoords and dimgs vs autograd of the plain version:
# the same terms summed in another order (dimgs by atomics), |dcoords| up to ~2e3 here
TOL_DCOORDS = dict(rtol=1e-5, atol=1e-5 * 255)
# one float32 step, kernel vs plain sampler, from one init and batch: the loss components
# come from identical forwards up to cuDNN's sum order (rtol 1e-5); after Adam's first
# step a parameter moved by ~lr * sign(g) in both, so every parameter is within 2 lr and
# all but 1 % within 1e-6 (tests/test_torch_train.py holds the port to JAX the same way)
TOL_STEP = {"loss_rtol": 1e-5, "param_atol": 1e-6, "param_share_off": 0.01}
# the bf16 step's first loss against the float32 one from the same init: bf16 activations
# (2^-8 relative) through ~45 convolutions; 0.08 % on the CPU at 64x96
TOL_BF16_LOSS = 0.02
# config 2, the second training path (train/experiments/depth_only.py defaults): 240x720
# pairs at their stored size, batch 10, bf16; validation every 2 steps at batch 1
C2_HEIGHT, C2_WIDTH, C2_BATCH, C2_STEPS, C2_VAL_CHECK = 240, 720, 10, 5, 2
# smoothness kernel launches (forward, backward) a step: one group call for the step's
# terms, a depth head per scale in config 2 (4 maps), depth and both flow channels per
# scale in config 4 (12); a validation's 4 terms are one forward launch
SMOOTH_PER_STEP = {"depth_only": (1, 1), "optflow_combine": (1, 1)}
SMOOTH_PER_VAL = 1
# the smoothness kernels vs the plain term: the forward sums the same terms in another
# order (tile sums, then a double sum), rtol 1e-5 as tests/test_pallas.py:69; the backward
# adds the same sgn(term) / (B count) contributions as autograd in another order, so it
# is within a few float32 ulp of max|g|
TOL_SMOOTH_FWD, TOL_SMOOTH_BWD = 1e-5, 1e-6
# split_training, the fourth and fifth paths (train/experiments/split_training.py
# defaults): DeMoN scenes at 192x256, batch 1, bf16; 5 steps of each phase
ST_HEIGHT, ST_WIDTH, ST_BATCH, ST_STEPS = 192, 256, 1, 5
# sig kernel launches (forward, backward) a step: one group call for the step's pairs,
# delta 2 at scales 2 and 3 in phase 1, at all four scales in phase 2
SIG_PER_STEP = {"pair": (1, 1), "single": (1, 1)}
# a sig group's coefficient in the parity and timing phases (a ramped sig weight)
SIG_COEF = 0.8
# the sig kernels vs the plain composition: the forward sums the same per-pixel roots in
# another order (tile sums, then a double sum), rtol 1e-5 as tests/test_pallas.py:56;
# the backward adds the same terms as autograd, rounded in another order, within 1e-6 of
# max|g| of autograd's gradient in each case (|g| is ~1e-6 to 1e-2 here, so an absolute
# 1e-6 as tests/test_pallas.py:66 would let a wrong B=8 gradient through); the gather
# formula is the kernel's arithmetic op for op, so the two are equal
TOL_SIG_FWD, TOL_SIG_BWD = 1e-5, 1e-6
FULL_SCALE_DELTAS = (1, 2, 4, 8, 16)
# the step at which the parity steps run: the sig weight ramps from 0 at step 0, so a
# step-0 parity would multiply the sig term's gradient by 0
PARITY_STEP = 1000
# config 3, the sixth path (train/experiments/depth_then_cam.py defaults): the
# full-resolution DepthPoseNet on DeMoN scenes at 192x256, batch 16, bf16; 5 steps
C3_HEIGHT, C3_WIDTH, C3_BATCH, C3_STEPS = 192, 256, 16, 5
# launches a config-3 step: one fused sampler group call for the Euler warps of the 4
# scales, and one smoothness group call for the terms of 1/disp at the 4 scales; none on
# the sampler's own route, no plain sampling
C3_PER_STEP = {"fused_fwd": 1, "fused_bwd": 1, "smoothness_fwd": 1, "smoothness_bwd": 1,
               "bilinear_sample": 0, "bilinear_sample_bwd": 0, "plain_samples": 0}
# the eval harness at config 3's size: batches, and sig forward launches a batch (one
# group call: the 5-delta term at scale 0 for the pair net, delta 2 at 4 scales for the
# single net)
EVAL_BATCHES = 2
SIG_PER_EVAL_BATCH = {"pair": 1, "single": 1}
# the tensor-core probes at the JAX probes' shapes, name -> (M, K, N, repeats):
# tools/probe_int8_dot.py:26-27 and tools/probe_int8_dot2.py:17
PROBE_SHAPES = {"dot_loop": (1024, 1024, 1024, 64), "dot_grid": (4096, 4096, 4096, 1)}
# launches of each probe kernel in its tool's run: 2 cases (int8, bf16) of 1 + 8 x 5 calls
# (tools/common.py:time_2arg); a transpose of B before each int8 product; the loop splits
# K = 1024 into 2 (int8) or 4 (bf16) parts, and adds them after each product
PROBE_TOOL_LAUNCHES = 2 * (1 + 8 * 5)
PROBE_TOOL_TRANSPOSES = 1 + 8 * 5
PROBE_TOOL_REDUCES = {"dot_loop": PROBE_TOOL_LAUNCHES, "dot_grid": 0}
# the SASS instructions counted in the probe and tail libraries: wgmma (HGMMA bf16, IGMMA
# int8), TMA loads and stores, and mma.sync (HMMA, IMMA), which wmma compiles to
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "HMMA", "IMMA")
# TurboDepthNet serving: the committed student whose weights the GPU machine's copy of
# the tree holds (the other presets' files stay off it), and the JAX turbo bench's batch
# (tools/bench_turbo.py:27)
TURBO_WEIGHTS = os.path.join(ROOT, "weights", "turbo_small_distilled_576x384.npz")
TURBO_BENCH_BATCH = 128
# the bf16 turbo serving forward against the float32 module forward, (max, mean) abs error.
# The mean limit is phase 5's. The max is not: TurboDepthNet rounds its head's logits and
# disparities to bf16 (as JAX's does), and disparities in [2, 4) lie 1.56e-2 apart in
# bf16, so the last two roundings alone can move a pixel by ~2.4e-2, the whole of phase
# 5's 2.5e-2; on seeded uint8 frames at 576x384 the JAX package's own bf16 forward is
# further than 2.5e-2 from its f32 module (tests/test_torch_turbo.py holds both packages
# to these limits)
TOL_TURBO_SERVING = (5e-2, 5e-3)
# distillation, a training path (train/experiments/distill_turbo.py defaults): the depth4
# teacher and a turbo-base student at 576x384, batch 8, bf16; 5 steps, a validation every
# 2. The teacher's eval forward runs the fused tail once a step and once a validation
DISTILL_BATCH, DISTILL_STEPS, DISTILL_VAL_CHECK = 8, 5, 2
TAIL_PER_DISTILL_STEP = TAIL_PER_DISTILL_VAL = 1
# one f32 distill step, the teacher's tail fused vs native: the tail's f32 kernel is within
# 2e-5 of its plain version on [0, 4] disparities (TOL_TAIL), which moves a mean L1 of
# ~1 by ~2e-5 at most; 1e-4 leaves room for cuDNN's sum order in the rest
TOL_DISTILL_LOSS = 1e-4
# DeviceCache: a 64-frame uint8 corpus at 576x384 (42 MB)
CACHE_FRAMES = 64
# config 5 (train/experiments/on_demon.py defaults): the truncated DepthPoseNet on DeMoN
# scenes at 192x256, batch 16, bf16; 5 steps. A step smooths disp3 and disp4 (scales 2 and
# 3) in one group call, and launches nothing else of the package
C5_HEIGHT, C5_WIDTH, C5_BATCH, C5_STEPS = 192, 256, 16, 5
# the symmetric L/R family (train/experiments/depth_then_cam_lr.py defaults): LRNet on
# DeMoN scenes at 192x256, batch 16, bf16; 5 steps of each mode. A step's 16 samplings (8
# image warps with dcoords, 8 inverse-depth resamples with dcoords and dimgs) are one
# sampler group call, its 1/d smoothness terms one group call (lr_full 16 maps, lr_gt 8),
# and under --gt_pose its 5-delta sig term one call; no plain sampling
LR_HEIGHT, LR_WIDTH, LR_BATCH, LR_STEPS = 192, 256, 16, 5
LR_MODES = {"lr_full": False, "lr_gt": True}   # mode -> --gt_pose
DEMON_PER_STEP = {"on_demon": {"smoothness_fwd": 1, "smoothness_bwd": 1},
            "lr_full": {"smoothness_fwd": 1, "smoothness_bwd": 1, "bilinear_sample": 1,
                        "bilinear_sample_bwd": 1},
            "lr_gt": {"smoothness_fwd": 1, "smoothness_bwd": 1, "bilinear_sample": 1,
                      "bilinear_sample_bwd": 1, "sig_fwd": 1, "sig_bwd": 1}}
# the colon-pair families (train/experiments/optflow_family.py and dim11.py defaults):
# optflow_family's five modes on 240x720 JPEG pairs resized to 224x480, dim11 on 224x224
# pairs in the dim11 layout, batch 10, bf16; 5 steps each
OF_HEIGHT, OF_WIDTH, OF_READ, OF_BATCH, OF_STEPS = 224, 480, (240, 720), 10, 5
D11_HW = (224, 224)
COLON_MODES = ("only_image", "optflow_only", "optflow3", "pre", "sfm", "dim11")
# the warps of a step: only_image and dim11 4 depth warps, optflow_only 4 flow warps, sfm
# 4 depth warps that feed only the record (under no_grad); optflow3's data_weight is 0, so
# it warps nothing
COLON_WARPS = {"only_image": 4, "optflow_only": 4, "optflow3": 0, "pre": 0, "sfm": 4,
               "dim11": 4}
# launches a step: one smoothness group call each way in every mode; one sampler group
# call each way where the preset's sampler is "pallas" (only_image, optflow_only, dim11);
# sfm keeps JAX's "xla", so its 4 forward-only warps are plain samplings
_SMOOTH = {"smoothness_fwd": 1, "smoothness_bwd": 1}
_SAMPLE = {"bilinear_sample": 1, "bilinear_sample_bwd": 1}
COLON_PER_STEP = {"only_image": {**_SMOOTH, **_SAMPLE}, "optflow_only": {**_SMOOTH, **_SAMPLE},
                  "optflow3": _SMOOTH, "pre": _SMOOTH,
                  "sfm": {**_SMOOTH, "plain_samples": COLON_WARPS["sfm"]},
                  "dim11": {**_SMOOTH, **_SAMPLE}}
# the maps of a step's smoothness group, every one an eligible C=1 map: the 4 heads,
# optflow_only's flow x and y (channel views of the 3-channel heads), and optflow3's and
# sfm's 3-channel heads as their 12 channel views
COLON_SMOOTH_MAPS = {"only_image": 4, "optflow_only": 8, "optflow3": 12, "pre": 4,
                     "sfm": 12, "dim11": 4}
# the colon-pair presets whose sampler is decided by the turns below: the two the port
# moves to "pallas" (only_image, dim11) and sfm, which keeps JAX's "xla" while its turns
# disagree between runs (optflow_only is JAX's own "pallas" and is not timed)
COLON_TIMED = ("optflow_family_only_image", "dim11", "optflow_family_sfm")
COLON_ROUNDS, COLON_ROUND_STEPS = 8, 5
# test-time refinement (infer/refine_cli.py's defaults): a two-view COLMAP text model of one
# synthetic scene at 224x224 with 64 anchors, depth4 DispNet in float32, B=1; 20 steps.
# A step's 4 smoothness maps are one group call each way; its 4 warps are one sampler
# call each way (coordinate gradients on all four) on the "pallas" route, and 4 plain
# samplings on "xla"; the preset is infer/refine.py:SAMPLER
RF_HW, RF_POINTS, RF_STEPS, RF_WARPS = (224, 224), 64, 20, 4
RF_ROUNDS, RF_ROUND_STEPS = 8, 5
RF_LR = 1e-4
# flow-augmented serving (FlowAugmentedPredictor's defaults): the truncated DepthPoseNet
# over 11 channels at 192x256, batch 16, bf16 folded forward
FLOW_HW, FLOW_BATCH = (192, 256), 16
# its bf16 answers against the f32 module forward: a sanity bound, not phase 5's limit.
# There are no trained weights of this net: a seeded init, its statistics warmed on raw
# 0..255 inputs, lets bf16 rounding grow layer by layer through the encoder, and JAX's own
# bf16 FlowAugmentedPredictor on the same net and inputs lies beyond 2.5e-2 max and 5e-3
# mean of its f32 module (tests/test_torch_models_extra.py asserts that and holds both
# packages here). The check of the path is the f32 folded forward at TOL_FORWARD.
TOL_FLOW_SERVING = (0.5, 0.1)
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32, PEAK_BF16, PEAK_HBM = 67e12, 989e12, 3.35e12
PEAK_INT8 = 1979e12


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke "
                         "runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "smi": smi.splitlines()[0]}
    print(f"device: {info['kind']} x{info['count']}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {info['smi']}")
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    entries = _build.build_all()   # one nvcc per source, all at once
    print(f"build: {len(entries)} kernels in {time.perf_counter() - t0:.2f} s wall")
    for name, entry in entries.items():
        print(f"build: {name}: nvcc {entry['seconds']:.2f} s wall")
        for line in entry["log"].splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {line.strip()}")


def tail_inputs(batch: int, dtype: torch.dtype, device) -> tuple:
    g = np.random.RandomState(SEED)
    h, w = HEIGHT // 2, WIDTH // 2
    x2 = np.abs(g.randn(batch, h, w, 32)).astype(np.float32)  # icnv2's output is post-ReLU
    d2 = (g.rand(batch, h, w, 1) * 4.0).astype(np.float32)    # sigmoid * 4
    return (torch.from_numpy(x2).to(device=device, dtype=dtype),
            torch.from_numpy(d2).to(device))


def phase_kernel(folded_by_dtype: dict, batches: tuple = (8, 16, 64)) -> dict:
    """The largest error of each dtype over ``batches``: 8 is serving's bucket; at 16 and
    64 the bf16 kernel's persistent blocks take about three and five items each, so its
    walk across items (the next item's TMA loads, the mbarrier phases) is checked too."""
    errs = {}
    for batch in batches:
        for dt, folded in folded_by_dtype.items():
            x2, d2 = tail_inputs(batch, dt, "cuda")
            got = fused_tail(x2, d2, folded["tail"])
            ref = fused_tail_reference(x2, d2, folded["tail"])
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"fused_tail {dt} B={batch}: non-finite output")
            err = (got - ref).abs().max().item()
            mean = (got - ref).abs().mean().item()
            tol_max, tol_mean = TOL_TAIL[dt]
            print(f"kernel fused_tail {str(dt)[6:]} B={batch} {tuple(x2.shape)}: abs err "
                  f"max {err:.3e}, mean {mean:.3e} vs fused_tail_reference, tolerance max "
                  f"{tol_max:.0e}, mean {tol_mean:.0e}")
            if err > tol_max or mean > tol_mean:
                raise AssertionError(f"fused_tail {dt} B={batch}: abs err max {err}, mean "
                                     f"{mean} beyond {tol_max}, {tol_mean}")
            errs[dt] = max(errs.get(dt, 0.0), err)
            del x2, d2, got, ref
    return errs


def _frames(n: int, height: int, width: int, seed: int = SEED) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, height, width, 3), np.uint8)


def phase_forward(variables: dict, device, height: int = HEIGHT, width: int = WIDTH,
                  batch: int = 8) -> dict:
    """f32 fast forward (fused and native tails) vs the plain module forward."""
    frames = torch.from_numpy(_frames(batch, height, width))
    before = fused_tail.launches
    with torch.inference_mode():
        fused = fast_depth_forward(variables, frames, dtype=torch.float32, tail="fused",
                                   device=device)
        launches = fused_tail.launches - before
        native = fast_depth_forward(variables, frames, dtype=torch.float32, tail="native",
                                    device=device)
        model = dispnet_from_variables(variables, device=device)
        ref = [r.permute(0, 2, 3, 1) for r in
               model(frames.to(device).permute(0, 3, 1, 2).float())]
    worst = 0.0
    for tail, got in (("fused", fused), ("native", native)):
        for i, (g, r) in enumerate(zip(got, ref), start=1):
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"forward {tail} d{i}: shape {tuple(g.shape)} vs "
                                     f"{tuple(r.shape)} or non-finite values")
            err = (g - r).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(g, r, rtol=TOL_FORWARD, atol=TOL_FORWARD):
                raise AssertionError(f"forward {tail} d{i}: max abs err {err} beyond "
                                     f"rtol = atol = {TOL_FORWARD}")
    print(f"forward f32 {height}x{width} B={batch}: fused and native tails match the "
          f"module forward, max abs err {worst:.3e} (rtol = atol = {TOL_FORWARD}); "
          f"fused_tail launches {launches}")
    return {"max_abs_err": worst, "launches": launches}


def phase_serving(variables: dict, device, height: int = HEIGHT, width: int = WIDTH,
                  batch: int = 8, use_fast: bool = True) -> dict:
    """DepthPredictor (bf16; the folded forward with the fused tail, or with ``use_fast``
    False the module's eval forward) answers requests of ``batch`` (at least 5), 5 and 1
    frames; each answer is held against the float32 module forward of the frames."""
    if batch < 5:
        raise ValueError(f"serving needs a batch of at least 5, got {batch}")
    frames = _frames(batch, height, width, seed=SEED + 1)
    with torch.inference_mode():
        model = dispnet_from_variables(variables, device=device)
        ref = model(torch.from_numpy(frames).to(device).permute(0, 3, 1, 2).float())
        ref = ref[0][:, 0].cpu().numpy()
    pred = DepthPredictor(variables["params"], variables["batch_stats"], height=height,
                          width=width, batch_size=batch, dtype=torch.bfloat16,
                          use_fast=use_fast, device=device)
    forward = "folded" if use_fast else "module"
    if pred.uses_fast_path != use_fast:
        raise AssertionError(f"DepthPredictor(use_fast={use_fast}) took the other forward")
    full = None
    for n in (batch, 5, 1):
        t0 = time.perf_counter()
        out = pred.predict_array(frames[:n])
        ms = (time.perf_counter() - t0) * 1e3
        if out.shape != (n, height, width) or not np.isfinite(out).all():
            raise AssertionError(f"serving {n} frames: shape {out.shape} or non-finite")
        diff = np.abs(out - ref[:n])
        err, mean = float(diff.max()), float(diff.mean())
        if err > TOL_SERVING[0] or mean > TOL_SERVING[1]:
            raise AssertionError(f"serving {n} frames: abs err max {err}, mean {mean} to "
                                 f"the f32 module forward beyond {TOL_SERVING}")
        full = out if full is None else full
        # a request padded to a bucket of ``batch`` runs at the full request's shape, so
        # each frame gets exactly what the full request gave it
        if n < batch and 1 << (n - 1).bit_length() == batch:
            pad_diff = float(np.abs(out - full[:n]).max())
            if pad_diff != 0.0:
                raise AssertionError(f"serving {n} frames differs from the full batch "
                                     f"by {pad_diff}")
        print(f"serving ({forward} forward): {n} frames -> {out.shape} float32, finite, "
              f"range [{out.min():.3f}, {out.max():.3f}], {ms:.1f} ms host clock, abs err max "
              f"{err:.3e}, mean {mean:.3e} to the f32 module forward (tolerance max "
              f"{TOL_SERVING[0]:.1e}, mean {TOL_SERVING[1]:.1e})")
    return {"frames": batch + 5 + 1}


def kind_ms(prof: dict, kind: str, per_step: int = 2):
    """``profile_step.profile``'s device ms a step of ``kind`` where its session kept the
    kind's ``per_step`` launches a step, else None: ``torch.profiler`` loses some or all
    kernel events of a few sessions a run."""
    if prof["kind_launches"].get(kind, 0) != per_step:
        return None
    return prof["kinds"].get(kind, 0.0)


def fmt_ms(ms, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tail_bound(batch: int, dtype: torch.dtype) -> tuple:
    """Least time (ms) an H100 SXM needs for the tail: each input read and the output
    written once, upcnv1/icnv1/disp1 multiply-adds at the peak for their operand type."""
    h, w = HEIGHT // 2, WIDTH // 2
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = batch * (h * w * 32 * esize + h * w * 4 + 4 * h * w * 4) + N_PARAMS * 4
    f_up = batch * h * w * 9 * 32 * 16 * 2
    f_ic = batch * 4 * h * w * 9 * 17 * 16 * 2
    f_d1 = batch * 4 * h * w * 9 * 16 * 2      # bf16 activations x f32 weights: f32
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops = (f_up + f_ic) / peak + f_d1 / PEAK_F32
    t_bytes = nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_times(folded_by_dtype: dict, smi: str) -> dict:
    """The tail kernel, its plain version, its bound and, as a yardstick of several calls
    (no single PyTorch call computes the tail), the native chain of the same layers that
    ``folded_forward(tail="native")`` runs (cuDNN's deconv and conv, the resize, the
    concat, the head) from the same x2 and d2; then the bf16 forward at B=64."""
    rows = {}
    for batch in (8, 64):
        for dt, folded in folded_by_dtype.items():
            x2, d2 = tail_inputs(batch, dt, "cuda")
            x2n, d2n = x2.permute(0, 3, 1, 2), d2.permute(0, 3, 1, 2)  # channels-last views
            p = folded["tail"]
            iters = 20 if batch == 8 else 5
            ms = time_ms(lambda: fused_tail(x2, d2, p), 4 * iters)
            plain = time_ms(lambda: fused_tail_reference(x2, d2, p), iters)
            with torch.inference_mode():
                native = time_ms(lambda: native_tail(folded, x2n, d2n, (HEIGHT, WIDTH)),
                                 iters)
            bound, by = tail_bound(batch, dt)
            rows[(batch, dt)] = {"ms": ms, "plain_ms": plain, "native_ms": native,
                                 "bound_ms": bound, "bound_by": by}
            print(f"time fused_tail {str(dt)[6:]} B={batch}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, native chain {native:.4f} ms, bound {bound:.4f} ms "
                  f"({by}), kernel/bound {ms / bound:.1f}x [{smi}]")
            del x2, d2, x2n, d2n
    batch = 64
    folded = folded_by_dtype[torch.bfloat16]
    x = torch.from_numpy(_frames(batch, HEIGHT, WIDTH)).cuda()
    for tail in ("fused", "native"):
        with torch.inference_mode():
            ms = time_ms(lambda: folded_forward(folded, x, tail=tail), 5)
        print(f"time forward bf16 {HEIGHT}x{WIDTH} B={batch} tail={tail}: {ms:.3f} ms/batch,"
              f" {batch / ms * 1e3:.1f} frames/s [{smi}]")
    return rows

def warp_coords(B: int, H: int, W: int, device, seed: int = SEED + 2) -> torch.Tensor:
    """The coords of a real depth warp: seeded depth in [0.8, 2.5], a translation of up to
    5 cm and a rotation of up to 0.02 rad about the optical axis, config 4's intrinsics."""
    g = np.random.RandomState(seed)
    depth = torch.from_numpy(g.uniform(0.8, 2.5, (B, H, W)).astype(np.float32))
    K = torch.tensor([[0.9 * W, 0.0, W / 2], [0.0, 0.9 * W, H / 2], [0.0, 0.0, 1.0]])
    pose = torch.eye(4).repeat(B, 1, 1)
    a = torch.from_numpy(g.uniform(-0.02, 0.02, B).astype(np.float32))
    pose[:, 0, 0], pose[:, 0, 1], pose[:, 1, 0], pose[:, 1, 1] = a.cos(), -a.sin(), a.sin(), a.cos()
    pose[:, :3, 3] = torch.from_numpy(g.uniform(-0.05, 0.05, (B, 3)).astype(np.float32))
    img = torch.zeros((B, H, W, 1))
    warp = projective_inverse_warp(img.to(device), depth.to(device), pose.to(device),
                                   K.expand(B, 3, 3).contiguous().to(device), fmt="matrix")
    return warp.coords


def sampler_cases(device) -> dict:
    """name -> (imgs [B,Hs,Ws,3] in [0, 255], coords [B,Ht,Wt,2]) at config 4's shapes."""
    g = np.random.RandomState(SEED + 3)
    B, H, W = C4_BATCH, C4_HEIGHT, C4_WIDTH
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    imgs = t(g.rand(B, H, W, 3) * 255)
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([gx, gy], -1)[None]
    return {
        "warp": (imgs, warp_coords(B, H, W, device)),
        "wild": (imgs, t(g.rand(B, H, W, 2) * [4 * W, 4 * H] - [2 * W, 2 * H])),
        "integer": (imgs, t(grid + g.randint(-3, 4, (B, H, W, 2)))),
        "odd": (t(g.rand(B, 37, 53, 3) * 255), t(g.rand(B, 29, 61, 2) * [55, 39] - 1)),
    }


SAMPLER_COUNTS = ("bilinear_sample", "bilinear_sample_bwd", "fused_fwd", "fused_bwd")


def _distinct_leaves(tensors: list, grads: list) -> tuple:
    """(a copy of each distinct tensor of ``tensors`` (by address) as a leaf, needing a
    gradient where any of its places' ``grads`` does, the copy in each place): warps of one
    image keep sharing it."""
    need = {}
    for t, g in zip(tensors, grads):
        need[t.data_ptr()] = need.get(t.data_ptr(), False) or g
    leaves, placed = {}, []
    for t in tensors:
        if t.data_ptr() not in leaves:
            leaves[t.data_ptr()] = t.detach().clone().requires_grad_(need[t.data_ptr()])
        placed.append(leaves[t.data_ptr()])
    return list(leaves.values()), placed


def group_check(label: str, group, warps: list, want: tuple, smi: str,
                dimgs: bool = False) -> dict:
    """Hold ``group`` on ``warps`` [(imgs, coords, needs dcoords[, needs dimgs])] to the
    plain version (``plain_group``) at seeded cotangents of the outputs: the launches of
    each group call (``SAMPLER_COUNTS``) equal to ``want``, out and wmask bit-equal,
    dcoords (and the images' gradients, of every member with ``dimgs``, else of the
    members that ask for them) within TOL_DCOORDS of autograd of the plain version,
    dcoords the same bits in two runs. Returns the largest differences."""
    g = np.random.RandomState(SEED + 6)
    douts = [torch.from_numpy(g.randn(*w[1].shape[:3], w[0].shape[3]).astype(np.float32))
             .to(w[0].device) for w in warps]
    need_i = [dimgs or (len(w) > 3 and w[3]) for w in warps]
    dimgs = any(need_i)
    ks = [k for k, w in enumerate(warps) if w[2] or need_i[k]]
    runs = []
    for fn in (group, group, plain_group):
        img_leaves, ims = _distinct_leaves([w[0] for w in warps], need_i)
        cs = [w[1].detach().clone().requires_grad_(w[2]) for w in warps]
        targets = [c for c in cs if c.requires_grad] + [i for i in img_leaves
                                                          if i.requires_grad]
        before = read_counts()
        outs, masks = fn(ims, cs)
        grads = torch.autograd.grad([outs[k] for k in ks], targets, [douts[k] for k in ks])
        after = read_counts()
        got = tuple(after[k] - before[k] for k in SAMPLER_COUNTS)
        if fn is group and got != want:
            raise AssertionError(f"{label}: launches {dict(zip(SAMPLER_COUNTS, got))}, not "
                                 f"{dict(zip(SAMPLER_COUNTS, want))}")
        runs.append(([o.detach() for o in outs], [m.detach() for m in masks], grads))
    (o1, m1, g1), (_, _, g2), (ro, rm, rg) = runs
    n_c = sum(w[2] for w in warps)
    if not all(_same_bits(a, b) for a, b in zip(g1[:n_c], g2[:n_c])):
        raise AssertionError(f"{label}: dcoords differ between two runs")
    errs = {"out": max((a - b).abs().nan_to_num().max().item() for a, b in zip(o1, ro)),
            "wmask": max((a - b).abs().nan_to_num().max().item() for a, b in zip(m1, rm))}
    if not all(_same_bits(a, b) for a, b in zip(o1 + m1, ro + rm)):
        raise AssertionError(f"{label}: forward differs from the plain version by {errs}")
    for what, got, ref in (("dcoords", g1[:n_c], rg[:n_c]), ("dimgs", g1[n_c:], rg[n_c:])):
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, equal_nan=True, **TOL_DCOORDS,
                                       msg=lambda m: f"{label} {what}: {m}")
        errs[what] = max([(a - r).abs().nan_to_num().max().item()
                          for a, r in zip(got, ref)] or [0.0])
    px = sum(w[1].shape[0] * w[1].shape[1] * w[1].shape[2] for w in warps)
    print(f"kernel {label}: {len(warps)} warps ({px} target pixels, {n_c} with dcoords"
          f"{f', {sum(need_i)} with dimgs' if dimgs else ''}): launches {dict(zip(SAMPLER_COUNTS, want))}; out "
          f"and wmask bit-equal to the plain version; dcoords abs err max "
          f"{errs['dcoords']:.3e}" + (f", dimgs {errs['dimgs']:.3e}" if dimgs else "")
          + f" vs autograd of the plain version (rtol {TOL_DCOORDS['rtol']:.0e}, atol "
          f"{TOL_DCOORDS['atol']:.2e}); dcoords bit-equal in two runs [{smi}]")
    return errs


def phase_sampler(device, smi: str) -> dict:
    """The sampler group on a config-4 step's 12 warps (``group_check``, without and with
    dimgs), then ``bilinear_sample`` on single calls: the forward bit-equal everywhere,
    dcoords on the real warp (with dimgs) and on integer coords."""
    warps = sampler_units.units(device)["config 4"]
    worst = {"out": 0.0, "wmask": 0.0, "dcoords": 0.0, "dimgs": 0.0}
    for dimgs in (False, True):
        errs = group_check("bilinear_sample_group, a config-4 step", bilinear_sample_group,
                           warps, (1, 1, 0, 0), smi, dimgs=dimgs)
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
    for name, (imgs, coords) in sampler_cases(device).items():
        got = bilinear_sample(imgs, coords)
        ref = bilinear_sample_reference(imgs, coords)
        torch.cuda.synchronize()
        for what, g, r in zip(("out", "wmask"), got, ref):
            err = (g - r).abs().max().item()
            print(f"kernel bilinear_sample {name} {tuple(imgs.shape)} at "
                  f"{tuple(coords.shape)}: {what} abs err {err:.1e} vs "
                  f"bilinear_sample_reference, bit-equal required [{smi}]")
            if not _same_bits(g, r):
                raise AssertionError(f"bilinear_sample {name} {what}: differs from the plain "
                                     f"version by {err}")
        if name not in ("warp", "integer"):
            continue
        g = np.random.RandomState(SEED + 4)
        dout = torch.from_numpy(g.randn(*imgs.shape[:1], *coords.shape[1:3], 3)
                                .astype(np.float32)).to(device)
        dmask = torch.from_numpy(g.randn(*coords.shape[:3], 1).astype(np.float32)).to(device)
        grads = []
        for fn in (bilinear_sample, bilinear_sample_reference):
            c = coords.clone().requires_grad_(True)
            i = imgs.clone().requires_grad_(name == "warp")
            out, mask = fn(i, c)
            torch.autograd.backward([out, mask], [dout, dmask])
            grads.append((c.grad, i.grad))
        err = (grads[0][0] - grads[1][0]).abs().max().item()
        msg = f"dcoords abs err max {err:.3e}"
        torch.testing.assert_close(grads[0][0], grads[1][0], **TOL_DCOORDS)
        worst["dcoords"] = max(worst["dcoords"], err)
        if name == "warp":
            err = (grads[0][1] - grads[1][1]).abs().max().item()
            msg += f", dimgs {err:.3e}"
            torch.testing.assert_close(grads[0][1], grads[1][1], **TOL_DCOORDS)
            worst["dimgs"] = max(worst["dimgs"], err)
        print(f"kernel bilinear_sample {name}: {msg} vs autograd of the plain version "
              f"(|dcoords| max {grads[1][0].abs().max().item():.1f}), tolerance rtol "
              f"{TOL_DCOORDS['rtol']:.0e}, atol {TOL_DCOORDS['atol']:.2e} [{smi}]")
    return worst


def write_dataset(root: str, batch: int = C4_BATCH, read_hw=C4_READ) -> str:
    """A synthetic colon pair dataset (JPEG pairs, raw depth, intrinsics, projections)
    with ``batch`` training pairs at ``read_hw``."""
    return write_colon_pair_dataset(os.path.join(root, "colon"), num_frames=2 * batch,
                                    H=read_hw[0], W=read_hw[1], seed=SEED)


def phase_training(device, dataset: str, *, height: int = C4_HEIGHT,
                   width: int = C4_WIDTH, read_hw=C4_READ, batch: int = C4_BATCH,
                   steps: int = C4_STEPS, dtype: str = "bfloat16", smi: str = "") -> dict:
    """The config-4 CLI for ``steps`` steps; every loss component finite; the checkpoint
    read back into depth10_flow DispNet and its eval forward finite."""
    ckpt = os.path.join(os.path.dirname(dataset), "checkpoints")
    t0 = time.perf_counter()
    state, _ = optflow_combine.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--batch_size", str(batch),
        "--max_steps", str(steps), "--summary_freq", "1", "--save_latest_freq", str(steps),
        "--image_height", str(read_hw[0]), "--image_width", str(read_hw[1]),
        "--resized_height", str(height), "--resized_width", str(width),
        "--dtype", dtype, "--device", str(device), "--seed", str(SEED)])
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    comps = ("total", "depth", "smooth", "optflow", "pixel")
    if state.step != steps or len(records) != steps or not all(
            np.isfinite(r[k]) for r in records for k in comps):
        raise AssertionError(f"training: step {state.step}, {len(records)} records, "
                             f"losses {records}")
    for r in records:
        print(f"training step {r['step']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in comps)
              + f" [{smi}]")
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    model = dispnet_from_variables(variables, device=device)
    x = torch.from_numpy(next(iter(BatchLoader(
        PairDepthDataset(dataset, image_height=read_hw[0], image_width=read_hw[1],
                         resized_height=height, resized_width=width),
        batch, num_workers=1)))["tgt_image"]).to(device).permute(0, 3, 1, 2)
    with torch.no_grad():
        outs = model(x)
    shapes = [(batch, c, height >> s, width >> s) for c in (1, 2) for s in range(4)]
    if model.variant.name != "depth10_flow" or [tuple(o.shape) for o in outs] != shapes \
            or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"checkpoint step {meta.get('step')}: {model.variant.name}, "
                             f"outputs {[tuple(o.shape) for o in outs]} or non-finite")
    print(f"training: {steps} steps of config 4 ({dtype}, {height}x{width}, batch {batch}) "
          f"through the CLI in {seconds:.1f} s host clock; every loss component finite; "
          f"model-{steps}.npz read back into DispNet({model.variant.name}), eval forward "
          f"finite, d1 in [{outs[0].min().item():.3f}, {outs[0].max().item():.3f}] [{smi}]")
    return {"steps": steps, "seconds": seconds}


def first_batch(dataset: str, device) -> dict:
    ds = PairDepthDataset(dataset, image_height=C4_READ[0], image_width=C4_READ[1],
                          resized_height=C4_HEIGHT, resized_width=C4_WIDTH)
    return to_device(next(iter(BatchLoader(ds, C4_BATCH, num_workers=1))), device)


def config4_state(device, sd: dict, dtype: torch.dtype):
    model = DispNet(DispNetVariant.depth10_flow(), dtype=dtype)
    model.load_state_dict(sd)
    return create_train_state(model.to(device))


def config4_step(sampler: str, batch: dict):
    h, w = batch["tgt_image"].shape[1:3]
    return make_optflow_combine_step(dataclasses.replace(
        LossWeights.optflow_combine(), height=h, width=w, sampler=sampler))


def phase_step_parity(device, batch: dict, smi: str) -> dict:
    """One f32 step with the kernels vs one with the plain sampler and smoothness term from
    one init and batch; the bf16 step's loss against the f32 one."""
    sd = copy.deepcopy(DispNet(DispNetVariant.depth10_flow(),
                               generator=torch.Generator().manual_seed(SEED)).state_dict())
    runs = {}
    for name, sampler, dtype in (("kernel", "pallas", torch.float32),
                                 ("plain", "xla", torch.float32),
                                 ("kernel_bf16", "pallas", torch.bfloat16)):
        # "plain": the plain sampler and the plain smoothness term
        with plain_smoothness() if name == "plain" else contextlib.nullcontext():
            state, metrics = config4_step(sampler, batch)(
                config4_state(device, sd, dtype), batch)
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.detach() for k, p in state.model.named_parameters()})
    return _compare_steps("config 4", runs, 2e-4, smi)


def phase_sampler_times(device, smi: str) -> dict:
    """A config-4 step's 12 warps three ways (one group call, the same kernels once a warp,
    the plain version) and ``grid_sample``, forward and forward + backward, twice in turns,
    beside the bound (``tools/sampler_units.py``); then one profiled config-4 step
    (``profile_step``): the sampler kernels' device time a step, and the profile itself
    (``"profile"``) for the phases after."""
    warps = sampler_units.units(device)["config 4"]
    row = sampler_units.time_unit(warps, sampler_units.ways("config 4"))
    sampler_units.report("config 4", warps, row, "bilinear_sample", smi)
    prof = profile_step.profile(steps=1, device=device, config="optflow_combine", top=0)
    row.update(device_ms=kind_ms(prof, "sampler kernels"), profile=prof)
    print(f"profile optflow_combine: sampler kernels {fmt_ms(row['device_ms'])} of device "
          f"time a step, of {prof['kernel_ms']:.2f} ms in {prof['launches']} launches "
          f"[{smi}]")
    return row


def phase_training_times(device, batch: dict, smi: str) -> dict:
    """ms/step of the bf16 config-4 step with the kernel and with the plain sampler, in
    turns (plain, kernel, kernel, plain) on one state."""
    sd = DispNet(DispNetVariant.depth10_flow(),
                 generator=torch.Generator().manual_seed(SEED)).state_dict()
    state = config4_state(device, sd, torch.bfloat16)
    steps = {"kernel": config4_step("pallas", batch), "plain": config4_step("xla", batch)}
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(time_ms(lambda: steps[name](state, batch), 10))
    out = {}
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        out[name] = ms
        print(f"time training step bf16 config 4 ({C4_HEIGHT}x{C4_WIDTH}, B={C4_BATCH}) sampler={name}: "
              f"{ms:.2f} ms/step ({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{C4_BATCH / ms * 1e3:.1f} frames/s [{smi}]")
    return out


def smooth_cases(device) -> dict:
    """name -> a [B, H, W, 1] float32 map on ``device``: config 2's four scales (B=10,
    disparities in [0, 4] as the sigmoid * 4 heads give), a strided C=1 flow plane, exact
    ties and an odd size."""
    g = np.random.RandomState(SEED + 6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    cases = {f"config2 s{s}": t(g.uniform(0, 4, (C2_BATCH, C2_HEIGHT >> s, C2_WIDTH >> s, 1)))
             for s in range(4)}
    # config 4's flow heads: NCHW [B, 2, H, W] viewed NHWC, channel 1 (batch stride 2HW)
    flow = t(g.randn(C4_BATCH, 2, C4_HEIGHT, C4_WIDTH))
    cases["flow plane"] = flow.permute(0, 2, 3, 1)[..., 1:2]
    cases["constant"] = t(np.full((C2_BATCH, 60, 180, 1), 1.5))
    cases["piecewise"] = t(np.kron(g.randint(0, 4, (C2_BATCH, 10, 18, 1)) * 0.25,
                                   np.ones((1, 6, 10, 1))))
    cases["odd 37x53"] = t(g.uniform(0, 4, (C2_BATCH, 37, 53, 1)))
    return cases


def _smooth_grad(fn, x: torch.Tensor):
    """(fn(x), d fn / d x) through autograd, x a view of a leaf as the step's heads are."""
    leaf = x.detach().clone().requires_grad_(True)
    out = fn(leaf)
    (grad,) = torch.autograd.grad(out, leaf)
    return out.detach(), grad


def _smooth_group_run(fn, leaves: list, maps: list, coefs: list):
    """(total, per_map, d total / d each leaf) of ``fn(maps, coefs)``."""
    total, per_map = fn(maps, coefs)
    grads = torch.autograd.grad(total, leaves)
    return total.detach(), per_map.detach(), grads


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / scale if scale else (a - b).abs().max().item()


def _each_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| / |b| over the elements."""
    return ((a - b).abs() / b.abs()).max().item()


def phase_smoothness(device, smi: str) -> dict:
    """The smoothness kernels vs the plain term. Single maps (a group of one): forward
    (float32 and float64 plain), backward (autograd of the plain term, and the gather
    formula), and the same bits twice. Whole steps' groups (config 4's 12 maps, config
    2's 4, optflow3's 12 channel views of its 3-channel heads, optflow_only's 8 flow
    planes): total and terms against the plain terms in float32 and float64, each leaf's
    gradient against autograd of the plain group, and the same bits twice; optflow3's
    total also against the f64 plain term of the 3-channel maps themselves."""
    worst = {"fwd": 0.0, "bwd_rel": 0.0}
    for name, x in smooth_cases(device).items():
        got, grad = _smooth_grad(smoothness_fused, x)
        got2, grad2 = _smooth_grad(smoothness_fused, x)
        ref, ref_grad = _smooth_grad(second_order_smoothness, x)
        ref64 = second_order_smoothness(x.double())
        gather = smoothness_backward_reference(x, torch.ones((), device=device))
        torch.cuda.synchronize()
        if not (torch.equal(got, got2) and torch.equal(grad, grad2)):
            raise AssertionError(f"smoothness {name}: two runs differ")
        err, err64 = abs(got.item() - ref.item()), abs(got.item() - ref64.item())
        scale = ref_grad.abs().max().item()
        gerr = (grad - ref_grad).abs().max().item()
        gather_err = (grad - gather).abs().max().item()
        print(f"kernel smoothness {name} {tuple(x.shape)} strides {x.stride()}: forward "
              f"{got.item():.7f}, abs err {err:.3e} vs plain f32, {err64:.3e} vs plain f64 "
              f"(rtol {TOL_SMOOTH_FWD:.0e}); backward abs err max {gerr:.3e} vs autograd, "
              f"{gather_err:.3e} vs the gather formula (|g| max {scale:.3e}, tolerance "
              f"{TOL_SMOOTH_BWD:.0e} x |g| max); two runs bit-equal [{smi}]")
        if err > TOL_SMOOTH_FWD * abs(ref.item()) or err64 > TOL_SMOOTH_FWD * abs(
                ref64.item()) or gerr > TOL_SMOOTH_BWD * scale \
                or gather_err > TOL_SMOOTH_BWD * scale:
            raise AssertionError(f"smoothness {name}: beyond its tolerances")
        worst["fwd"] = max(worst["fwd"], err)
        worst["bwd_rel"] = max(worst["bwd_rel"], gerr / scale if scale else 0.0)
    for config in ("optflow_combine", "depth_only", "optflow3", "optflow_only"):
        leaves, maps, coefs = step_smooth_group(config, device)
        got = _smooth_group_run(smoothness_fused_group, leaves, maps, coefs)
        got2 = _smooth_group_run(smoothness_fused_group, leaves, maps, coefs)
        ref = _smooth_group_run(smoothness_plain_group, leaves, maps, coefs)
        terms64 = torch.tensor([second_order_smoothness(m.detach().double()).item()
                                for m in maps], dtype=torch.float64)
        total64 = sum(c * t for c, t in zip(coefs, terms64.tolist()))
        torch.cuda.synchronize()
        if not (torch.equal(got[0], got2[0]) and torch.equal(got[1], got2[1])
                and all(torch.equal(a, b) for a, b in zip(got[2], got2[2]))):
            raise AssertionError(f"smoothness group {config}: two runs differ")
        terms = got[1].cpu()
        err = _each_rel(terms, ref[1].cpu())
        err64 = _each_rel(terms.double(), terms64)
        total_err = max(_rel(got[0].item(), ref[0].item()), _rel(got[0].item(), total64))
        gerr = max(_max_rel(g, r) for g, r in zip(got[2], ref[2]))
        px = sum(m.shape[0] * m.shape[1] * m.shape[2] for m in maps)
        print(f"kernel smoothness group {config} ({len(maps)} maps, {px} pixels): total "
              f"{got[0].item():.7f}, rel err {total_err:.3e} vs plain f32 and f64; terms "
              f"max rel err {err:.3e} vs plain f32, {err64:.3e} vs plain f64 (rtol "
              f"{TOL_SMOOTH_FWD:.0e}); each leaf's gradient within {gerr:.3e} x its |g| max "
              f"of autograd of the plain group (tolerance {TOL_SMOOTH_BWD:.0e}); two runs "
              f"bit-equal [{smi}]")
        if config == "optflow3":   # the views' total against the 3-channel maps' terms
            whole = sum(c * 3 * second_order_smoothness(leaf.detach().double().permute(
                0, 2, 3, 1)).item() for c, leaf in zip(coefs[::3], leaves))
            total_err = max(total_err, _rel(got[0].item(), whole))
            print(f"kernel smoothness group optflow3: total {got[0].item():.7f} against "
                  f"the f64 plain term of the four 3-channel maps {whole:.7f}, rel err "
                  f"{_rel(got[0].item(), whole):.3e} (rtol {TOL_SMOOTH_FWD:.0e}) [{smi}]")
        if max(err, err64, total_err) > TOL_SMOOTH_FWD or gerr > TOL_SMOOTH_BWD:
            raise AssertionError(f"smoothness group {config}: beyond its tolerances")
        worst["fwd"] = max(worst["fwd"], (got[0] - ref[0]).abs().item())
        worst["bwd_rel"] = max(worst["bwd_rel"], gerr)
    return worst


def _train_records(directory: str, steps: int, val_check: int, train_keys, val_keys,
                   label: str, smi: str) -> list:
    """A CLI run's ``metrics.jsonl``: ``steps`` train and ``steps // val_check`` val
    records with finite ``train_keys`` and ``val_keys``, each printed; returns the val
    records."""
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["scope"] == "train"]
    val = [r for r in records if r["scope"] == "val"]
    finite = all(np.isfinite(r[k]) for r in train for k in train_keys) \
        and all(np.isfinite(r[k]) for r in val for k in val_keys)
    if len(train) != steps or len(val) != steps // val_check or not finite:
        raise AssertionError(f"{label}: records {records}")
    for r in records:
        print(f"{label} {r['scope']} step {r['step']}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items() if k not in ("step", "scope")) + f" [{smi}]")
    return val


def phase_depth_only(device, dataset: str, *, height: int = C2_HEIGHT,
                     width: int = C2_WIDTH, batch: int = C2_BATCH, steps: int = C2_STEPS,
                     val_check: int = C2_VAL_CHECK, dtype: str = "bfloat16",
                     smi: str = "") -> dict:
    """The config-2 CLI for ``steps`` steps with validation every ``val_check``; every
    train and val record finite; the checkpoint read back into depth4 DispNet."""
    ckpt = os.path.join(os.path.dirname(dataset), "checkpoints_depth_only")
    t0 = time.perf_counter()
    state, _ = depth_only.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--batch_size", str(batch),
        "--max_steps", str(steps), "--summary_freq", "1", "--save_latest_freq", str(steps),
        "--validation_check", str(val_check), "--image_height", str(height),
        "--image_width", str(width), "--dtype", dtype, "--device", str(device),
        "--seed", str(SEED)])
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if state.step != steps:
        raise AssertionError(f"depth_only stopped at step {state.step}")
    val = _train_records(ckpt, steps, val_check, ("total", "depth", "smooth"),
                         ("total", "si_log_rmse", "smooth"), "depth_only", smi)
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    model = dispnet_from_variables(variables, device=device)
    x = torch.from_numpy(_frames(batch, height, width)).to(device).permute(0, 3, 1, 2).float()
    with torch.no_grad():
        outs = model(x)
    shapes = [(batch, 1, height >> s, width >> s) for s in range(4)]
    if model.variant.name != "depth4" or [tuple(o.shape) for o in outs] != shapes \
            or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"depth_only checkpoint step {meta.get('step')}: "
                             f"{model.variant.name}, {[tuple(o.shape) for o in outs]}")
    print(f"depth_only: {steps} steps of config 2 ({dtype}, {height}x{width}, batch {batch}) "
          f"and {len(val)} validations through the CLI in {seconds:.1f} s host clock; every "
          f"record finite; model-{steps}.npz read back into DispNet(depth4), eval forward "
          f"finite [{smi}]")
    return {"steps": steps, "validations": len(val), "seconds": seconds, "checkpoint": ckpt}


def smooth_bound(pixels: int, backward: bool) -> tuple:
    """Least time (ms) an H100 SXM needs for smoothness calls over ``pixels`` pixels in
    all: the map read once (and for the backward the gradient written once), and ~18
    float32 operations a pixel forward (6 first and 4 second differences, 4 abs, 4 adds)
    or ~35 backward (the 4 terms' signs, their weighted gather and the scaling)."""
    nbytes = 4 * pixels * (2 if backward else 1)
    t_bytes, t_ops = nbytes / PEAK_HBM, pixels * (35 if backward else 18) / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def step_smooth_group(config: str, device):
    """(leaves, maps, coefs) of a step's smoothness group, as the step's heads reach the
    loss: config 2's 4 depth heads (NCHW [B,1,H,W] viewed NHWC); config 4's depth heads
    and both channels of its flow heads ([B,2,H,W] viewed NHWC), at each of 4 scales; each
    map at its scale's coefficient, smooth_weight / 2**s. ``optflow3``: sfm's 3-channel
    linear heads ([B,3,H,W] viewed NHWC) as their 3 channel views at a third of it each,
    as ``losses/pipelines.py:_smooth_loss`` routes them (12 maps); ``optflow_only``:
    channels 0 and 1 of the same heads, flow x and y (8 maps); both at 224x480, B=10.
    The maps are views of the leaves."""
    g = np.random.RandomState(SEED + 7)
    weight = getattr(LossWeights, config)().smooth_weight
    B, H, W = (C2_BATCH, C2_HEIGHT, C2_WIDTH) if config == "depth_only" else \
        (C4_BATCH, C4_HEIGHT, C4_WIDTH)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device).requires_grad_(True)
    leaves, maps, coefs = [], [], []
    for s in range(4):
        h, w, c = H >> s, W >> s, weight / 2**s
        if config in ("optflow3", "optflow_only"):
            heads = t(g.randn(B, 3, h, w))
            leaves.append(heads)
            views = heads.permute(0, 2, 3, 1)
            if config == "optflow3":
                maps += [views[..., k:k + 1] for k in range(3)]
                coefs += [c / 3] * 3
            else:
                maps += [views[..., 0:1], views[..., 1:2]]
                coefs += [c] * 2
            continue
        depth = t(g.uniform(0, 4, (B, 1, h, w)))
        leaves.append(depth)
        maps.append(depth.permute(0, 2, 3, 1))
        coefs.append(c)
        if config == "optflow_combine":
            heads = t(g.randn(B, 2, h, w))
            leaves.append(heads)
            maps += [heads.permute(0, 2, 3, 1)[..., 0:1], heads.permute(0, 2, 3, 1)[..., 1:2]]
            coefs += [c] * 2
    return leaves, maps, coefs


def _time_smooth(maps: list, coefs: list) -> dict:
    """ms of the forward alone and of the forward and backward over a group of maps, three
    ways: ``group``, one group call as the pipelines make it; ``loop``, the same kernels
    called once a map (``smoothness_fused``, the pipelines' earlier call pattern);
    ``plain``, the plain term map by map. The backward runs to a copy of each map as a
    leaf (the copy keeps a dense map's strides), as in the earlier PRs' timings: in a step
    the views' own backward serves the other terms that read them too."""
    leaves = [m.detach().clone().requires_grad_(True) for m in maps]
    ways = {"group": lambda ms: smoothness_fused_group(ms, coefs)[0],
            "loop": lambda ms: sum(c * smoothness_fused(m) for c, m in zip(coefs, ms)),
            "plain": lambda ms: smoothness_plain_group(ms, coefs)[0]}
    return _time_ways(ways, maps, leaves)


def _time_ways(ways: dict, maps: list, leaves: list) -> dict:
    """ms of each way's forward alone (``ways[name](maps)`` without autograd) and forward
    and backward (to ``leaves``), in two turns, the ways in their order and then in the
    reverse one (the host's speed drifts within a run); 50 calls a turn, 20 for the plain
    way. ``<name>_fwd`` and ``<name>_fwdbwd`` are the turns' mean, ``..._turns`` the
    turns."""
    out = {}
    for name in [*ways, *reversed(ways)]:
        fn, iters = ways[name], 20 if name == "plain" else 50
        with torch.no_grad():
            fwd = time_ms(lambda: fn(maps), iters)
        both = time_ms(lambda: torch.autograd.grad(fn(leaves), leaves), iters)
        out.setdefault(f"{name}_fwd_turns", []).append(fwd)
        out.setdefault(f"{name}_fwdbwd_turns", []).append(both)
    for name in ways:
        for part in ("fwd", "fwdbwd"):
            turns = out[f"{name}_{part}_turns"]
            out[f"{name}_{part}"] = sum(turns) / len(turns)
    return out


def _turns(r: dict) -> str:
    """The forward + backward turns of each way of a ``_time_ways`` row."""
    return "; ".join(f"{k[:-len('_fwdbwd_turns')]} " + ", ".join(f"{t:.4f}" for t in v)
                     for k, v in r.items() if k.endswith("_fwdbwd_turns"))


def phase_smooth_times(device, smi: str, prof: dict) -> dict:
    """The kernels against the plain term, forward and forward + backward, three ways
    (``_time_smooth``), beside the bound: config 2's scale-0 map alone, and the groups of
    a config-2 and a config-4 step; then the smoothness kernels' device time in the
    profiled config-4 step ``prof`` (``profile_step``)."""
    x = step_smooth_group("depth_only", device)[1][0]
    px = x.shape[0] * x.shape[1] * x.shape[2]
    row = _time_smooth([x], [1.0])
    bf, by = smooth_bound(px, False)
    bb, _ = smooth_bound(px, True)
    print(f"time smoothness config 2 scale 0 {tuple(x.shape)}: forward kernel "
          f"{row['group_fwd']:.4f} ms, plain {row['plain_fwd']:.4f} ms, bound {bf:.4f} ms "
          f"({by}); forward+backward kernel {row['group_fwdbwd']:.4f} ms, plain "
          f"{row['plain_fwdbwd']:.4f} ms, bound {bf + bb:.4f} ms [{smi}]")
    rows = {"scale0": row}
    for config in ("depth_only", "optflow_combine"):
        _, maps, coefs = step_smooth_group(config, device)
        px = sum(m.shape[0] * m.shape[1] * m.shape[2] for m in maps)
        r = _time_smooth(maps, coefs)
        bf, by = smooth_bound(px, False)
        bb, _ = smooth_bound(px, True)
        rows[config] = {**r, "bound_fwd": bf, "bound_bwd": bb, "bound_by": by}
        print(f"time smoothness, the {len(maps)} maps of a {config} step ({px} pixels): "
              f"forward group {r['group_fwd']:.4f} ms, per-map loop {r['loop_fwd']:.4f} ms, "
              f"plain {r['plain_fwd']:.4f} ms, bound {bf:.4f} ms ({by}); forward+backward "
              f"group {r['group_fwdbwd']:.4f} ms, per-map loop {r['loop_fwdbwd']:.4f} ms, "
              f"plain {r['plain_fwdbwd']:.4f} ms, bound {bf + bb:.4f} ms; turns "
              f"{_turns(r)} [{smi}]")
    rows["optflow_combine"]["device_ms"] = kind_ms(prof, "smoothness kernels")
    print(f"profile optflow_combine: smoothness kernels "
          f"{fmt_ms(rows['optflow_combine']['device_ms'])} of device time a step, of "
          f"{prof['kernel_ms']:.2f} ms in "
          f"{prof['launches']} launches [{smi}]")
    return rows


def phase_depth_only_times(device, smi: str) -> dict:
    """ms/step of the bf16 config-2 step with the smoothness kernels and with the plain
    term, in turns (plain, kernel, kernel, plain) on one state and batch."""
    from tf_depth_estimation_torch.train.profile_step import pair_batch

    batch = pair_batch(C2_BATCH, C2_HEIGHT, C2_WIDTH, SEED, device)
    model = DispNet(DispNetVariant.depth4(), generator=torch.Generator().manual_seed(SEED),
                    dtype=torch.bfloat16).to(device)
    state = create_train_state(model)
    step = make_depth_only_step(dataclasses.replace(
        LossWeights.depth_only(), height=C2_HEIGHT, width=C2_WIDTH))
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        with plain_smoothness() if name == "plain" else contextlib.nullcontext():
            times[name].append(time_ms(lambda: step(state, batch), 10))
    out = {}
    for name, ts in times.items():
        out[name] = sum(ts) / len(ts)
        print(f"time training step bf16 config 2 ({C2_HEIGHT}x{C2_WIDTH}, B={C2_BATCH}) "
              f"smoothness={name}: {out[name]:.2f} ms/step (turns "
              f"{', '.join(f'{t:.2f}' for t in ts)}; spread {max(ts) - min(ts):.2f} ms), "
              f"{C2_BATCH / out[name] * 1e3:.1f} frames/s [{smi}]")
    return out


def sig_cases(device) -> dict:
    """name -> (pred base, view, gt, deltas): ``view(base)`` is the [B, H, W, 1] prediction.
    Phase 2's four scales (B=1, delta 2), the 5-delta full_scales call at 192x256 (B=1 and
    8), the eval harness's calls at config 3's size (B=16: the pair net's 5-delta call at
    192x256, the single net's delta-2 calls at its four scales, each an NCHW [B, 1, H, W]
    head viewed NHWC as the harness passes it), a coarse map that the longer deltas
    overreach, an odd size, and channel 1 of an NCHW [B, 2, H, W] head viewed NHWC. Values
    as the heads and labels give: disparities in (0, 4], inverse depths of 0.4 to 2.5 m."""
    g = np.random.RandomState(SEED + 8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    same = lambda x: x
    cases = {}

    def add(name, B, H, W, deltas):
        cases[name] = (t(g.uniform(0.05, 4, (B, H, W, 1))), same,
                       t(1 / g.uniform(0.4, 2.5, (B, H, W, 1))), deltas)

    for s in range(4):
        add(f"phase2 s{s}", ST_BATCH, ST_HEIGHT >> s, ST_WIDTH >> s, (2,))
    add("full_scales B=1", 1, ST_HEIGHT, ST_WIDTH, FULL_SCALE_DELTAS)
    add("full_scales B=8", 8, ST_HEIGHT, ST_WIDTH, FULL_SCALE_DELTAS)
    nchw = lambda x: x.permute(0, 2, 3, 1)

    def add_head(name, B, H, W, deltas):
        cases[name] = (t(g.uniform(0.05, 4, (B, 1, H, W))), nchw,
                       t(1 / g.uniform(0.4, 2.5, (B, H, W, 1))), deltas)

    add_head(f"eval pair B={C3_BATCH}", C3_BATCH, C3_HEIGHT, C3_WIDTH, FULL_SCALE_DELTAS)
    for s in range(4):
        add_head(f"eval single B={C3_BATCH} s{s}", C3_BATCH, C3_HEIGHT >> s, C3_WIDTH >> s,
                 (2,))
    add("coarse 12x16", 2, 12, 16, FULL_SCALE_DELTAS)   # d = 16 >= H and >= W
    add("odd 37x53", 2, 37, 53, FULL_SCALE_DELTAS)
    head = t(g.uniform(0.05, 4, (2, 2, 48, 64)))
    cases["strided plane"] = (head, lambda x: x.permute(0, 2, 3, 1)[..., 1:2],
                              t(1 / g.uniform(0.4, 2.5, (2, 48, 64, 1))), (2,))
    return cases


def _sig_grad(fn, base, view, gt, deltas):
    """(fn(view(base), gt), d/d view(base), d/d gt) through autograd, the prediction a
    view of a leaf as the step's heads are."""
    leaf, gleaf = base.detach().clone().requires_grad_(True), gt.detach().clone().requires_grad_(True)
    out = fn(view(leaf), gleaf, deltas)
    dbase, dgt = torch.autograd.grad(out, [leaf, gleaf])
    return out.detach(), view(dbase), dgt


def phase_sig(device, smi: str) -> dict:
    """The sig kernels vs the plain composition. Single pairs (a group of one): forward
    (float32 and float64 plain), backward for pred and gt (autograd of the plain version,
    and the gather formula), and the same bits twice. Whole steps' groups (split_training's
    phase 2 and phase 1, the single net's eval batch) at ``SIG_COEF``: total and terms
    against the plain composition in float32 and float64, d pred and d gt of each pair
    against autograd of the plain group and, bit for bit, the gather formula at the
    coefficient, and the same bits twice."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, (base, view, gt, deltas) in sig_cases(device).items():
        got, dp, dg = _sig_grad(sig_l2_fused, base, view, gt, deltas)
        got2, dp2, dg2 = _sig_grad(sig_l2_fused, base, view, gt, deltas)
        ref, rp, rg = _sig_grad(sig_l2_plain, base, view, gt, deltas)
        x = view(base)
        ref64 = sig_l2_plain(x.double(), gt.double(), deltas)
        gp, gg = sig_l2_backward_reference(x, gt, torch.ones((), device=device), deltas)
        torch.cuda.synchronize()
        if not (torch.equal(got, got2) and torch.equal(dp, dp2) and torch.equal(dg, dg2)):
            raise AssertionError(f"sig {name}: two runs differ")
        err, err64 = abs(got.item() - ref.item()), abs(got.item() - ref64.item())
        # each gradient (d pred, d gt) within TOL_SIG_BWD of its own max|g|
        gerrs = [((a - r).abs().max().item(), TOL_SIG_BWD * r.abs().max().item())
                 for a, r in ((dp, rp), (dg, rg))]
        (ep, tp), (eg, tg) = gerrs
        gather_equal = torch.equal(dp, gp) and torch.equal(dg, gg)
        print(f"kernel sig_l2 {name} {tuple(x.shape)} strides {x.stride()} deltas {deltas}: "
              f"forward {got.item():.7f}, abs err {err:.3e} vs plain f32, {err64:.3e} vs "
              f"plain f64 (rtol {TOL_SIG_FWD:.0e}); backward abs err vs autograd {ep:.3e} "
              f"d pred (limit {tp:.3e}), {eg:.3e} d gt (limit {tg:.3e}), limits "
              f"{TOL_SIG_BWD:.0e} of max|g|; bit-equal to the gather formula: "
              f"{gather_equal}; two runs bit-equal [{smi}]")
        if err > TOL_SIG_FWD * abs(ref.item()) or err64 > TOL_SIG_FWD * abs(ref64.item()) \
                or any(e > t for e, t in gerrs) or not gather_equal:
            raise AssertionError(f"sig {name}: beyond its tolerances")
        worst["fwd"] = max(worst["fwd"], err)
        worst["bwd"] = max(worst["bwd"], ep, eg)
    cases = sig_cases(device)
    for label, names in (("phase-2 step", [f"phase2 s{s}" for s in range(4)]),
                         ("phase-1 step", [f"phase2 s{s}" for s in (2, 3)]),
                         (f"single-net eval batch, B={C3_BATCH}",
                          [f"eval single B={C3_BATCH} s{s}" for s in range(4)])):
        group = [cases[n] for n in names]
        coefs = [SIG_COEF] * len(group)
        got = _sig_group_run(sig_l2_fused_group, group, coefs)
        got2 = _sig_group_run(sig_l2_fused_group, group, coefs)
        ref = _sig_group_run(sig_l2_plain_group, group, coefs)
        terms64 = torch.tensor([sig_l2_plain(view(base).double(), gt.double(), deltas).item()
                                for base, view, gt, deltas in group], dtype=torch.float64)
        total64 = sum(c * t for c, t in zip(coefs, terms64.tolist()))
        gather = [sig_l2_backward_reference(view(base), gt,
                                            torch.tensor(c, device=device), deltas)
                  for (base, view, gt, deltas), c in zip(group, coefs)]
        torch.cuda.synchronize()
        if not (torch.equal(got[0], got2[0]) and torch.equal(got[1], got2[1])
                and all(torch.equal(a, b) for a, b in zip(got[2], got2[2]))):
            raise AssertionError(f"sig group {label}: two runs differ")
        terms = got[1].cpu()
        err = _each_rel(terms, ref[1].cpu())
        err64 = _each_rel(terms.double(), terms64)
        total_err = max(_rel(got[0].item(), ref[0].item()), _rel(got[0].item(), total64))
        gerr = max(_max_rel(g, r) for g, r in zip(got[2], ref[2]))
        K = len(group)
        gather_equal = all(torch.equal(got[2][k], gp) and torch.equal(got[2][K + k], gg)
                           for k, (gp, gg) in enumerate(gather))
        print(f"kernel sig_l2 group, {label} ({K} pairs, deltas {group[0][3]}, coefficient "
              f"{SIG_COEF}): total {got[0].item():.7f}, rel err {total_err:.3e} vs plain f32 "
              f"and f64; terms max rel err {err:.3e} vs plain f32, {err64:.3e} vs plain f64 "
              f"(rtol {TOL_SIG_FWD:.0e}); d pred and d gt of each pair within {gerr:.3e} x "
              f"its |g| max of autograd of the plain group (tolerance {TOL_SIG_BWD:.0e}); "
              f"bit-equal to the gather formula at the coefficient: {gather_equal}; two runs "
              f"bit-equal [{smi}]")
        if max(err, err64, total_err) > TOL_SIG_FWD or gerr > TOL_SIG_BWD or not gather_equal:
            raise AssertionError(f"sig group {label}: beyond its tolerances")
        worst["fwd"] = max(worst["fwd"], (got[0] - ref[0]).abs().item())
    return worst


def _sig_group_run(fn, group: list, coefs: list):
    """(total, per_map, [d pred of each pair] + [d gt of each pair]) of ``fn`` on a group
    of ``sig_cases`` entries (one set of deltas), the predictions views of leaves."""
    leaves = [b.detach().clone().requires_grad_(True) for b, _, _, _ in group]
    gts = [g.detach().clone().requires_grad_(True) for _, _, g, _ in group]
    total, per_map = fn([v(b) for b, (_, v, _, _) in zip(leaves, group)], gts,
                        group[0][3], coefs)
    grads = torch.autograd.grad(total, leaves + gts)
    dp = [v(g) for g, (_, v, _, _) in zip(grads, group)]
    return total.detach(), per_map.detach(), dp + list(grads[len(group):])


def demon_batches(batch: int, height: int, width: int, device, seed: int = SEED):
    """An endless stream of DeMoN batches of synthetic scenes (``demon_batch``)."""
    rng = np.random.RandomState(seed)
    while True:
        yield demon_batch(batch, height, width, rng, device)


def _records(directory: str, comps) -> list:
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if not all(np.isfinite(r[k]) for r in records for k in comps):
        raise AssertionError(f"non-finite loss in {directory}: {records}")
    return records


def phase_split_training(device, root: str, *, height: int = ST_HEIGHT,
                         width: int = ST_WIDTH, batch: int = ST_BATCH,
                         steps: int = ST_STEPS, dtype: str = "bfloat16",
                         smi: str = "") -> dict:
    """split_training's two phases for ``steps`` steps each through the CLI's
    ``train_pair`` and ``train_single``, with the launch counts set to 0 before each phase
    and read after it; every loss component finite; both checkpoint groups read back
    into DepthPoseNet and a 4-channel DispNet with finite eval forwards. Returns the
    launch counts of each phase, and phase 1's checkpoint (the truncated DepthPoseNet) as
    ``pair_variables``."""
    pair_dir, single_dir = os.path.join(root, "pair"), os.path.join(root, "single")
    args = split_training.parse_args([
        "--checkpoint_dir", pair_dir, "--checkpoint_dir_single", single_dir,
        "--image_height", str(height), "--image_width", str(width),
        "--batch_size", str(batch), "--max_steps", str(steps),
        "--max_steps_single", str(steps), "--summary_freq", "1",
        "--save_latest_freq", str(steps), "--dtype", dtype, "--device", str(device),
        "--seed", str(SEED)])
    w = split_training.loss_weights(args)
    out = {}
    t0 = time.perf_counter()
    reset_counts()  # a main path: phase 1
    pair = split_training.train_pair(args, w, split_training.pair_state(args),
                                     demon_batches(batch, height, width, device))
    out["pair"] = read_counts()
    reset_counts()  # a main path: phase 2
    single = split_training.train_single(args, w, pair,
                                         demon_batches(batch, height, width, device,
                                                       seed=SEED + 1))
    out["single"] = read_counts()
    out["seconds"] = time.perf_counter() - t0
    recs = {"pair": _records(pair_dir, ("total", "depth", "cam", "consist", "sig", "exp")),
            "single": _records(single_dir, ("total", "depth", "sig"))}
    if pair.step != steps or single.step != steps or any(len(r) != steps
                                                         for r in recs.values()):
        raise AssertionError(f"split_training: steps {pair.step}, {single.step}, "
                             f"records {recs}")
    for phase, records in recs.items():
        for r in records:
            print(f"split_training {phase} step {r['step']}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r.items()
                if k not in ("step", "scope", "steps_per_sec", "frames_per_sec")) + f" [{smi}]")
    x = next(demon_batches(batch, height, width, device, seed=SEED + 2))
    pv, _ = load_variables_npz(os.path.join(pair_dir, f"{split_training.PAIR_GROUP}-{steps}.npz"))
    sv, _ = load_variables_npz(os.path.join(single_dir,
                                            f"{split_training.SINGLE_GROUP}-{steps}.npz"))
    pair_model = depth_pose_from_variables(pv, device=device)
    single_model = dispnet_from_variables(sv, device=device)
    with torch.no_grad():
        disps, pose, masks = pair_model(x["image_pair"].permute(0, 3, 1, 2))
        inp = next(split_training.single_batches(pair_model, iter([x])))["input"]
        depths = single_model(inp.permute(0, 3, 1, 2))
    shapes = [(batch, 1, height >> s, width >> s) for s in (2, 3)]
    outs = [*disps, pose, *masks, *depths]
    if pair_model.full_resolution or [tuple(d.shape) for d in disps] != shapes \
            or single_model.encoder["cnv1"].conv.weight.shape[1] != 4 or len(depths) != 4 \
            or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"split_training checkpoints: {[tuple(o.shape) for o in outs]}")
    print(f"split_training: {steps} steps of phase 1 and {steps} of phase 2 ({dtype}, "
          f"{height}x{width}, batch {batch}) in {out['seconds']:.1f} s host clock; every loss "
          f"component finite; {split_training.PAIR_GROUP}-{steps}.npz read back into "
          f"DepthPoseNet and {split_training.SINGLE_GROUP}-{steps}.npz into a 4-channel "
          f"DispNet(depth4), eval forwards finite [{smi}]")
    out["pair_variables"] = pv
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def _parity_run(phase: str, sd: dict, batch: dict, device, dtype, plain: bool):
    """One step of ``phase`` from the state dict ``sd`` at step PARITY_STEP; (metrics,
    parameters after the step)."""
    w = dataclasses.replace(LossWeights.split_training(), height=ST_HEIGHT, width=ST_WIDTH)
    if phase == "pair":
        model = DepthPoseNet(dtype=dtype)
        state = create_train_state(model, lr_schedule=exponential_decay(2e-4, 10000, 0.96))
        step = make_pairwise_step(w)
    else:
        model = DispNet(DispNetVariant.depth4(), in_channels=4, dtype=dtype)
        state = create_train_state(model)
        step = make_single_depth_step(w)
    model.load_state_dict(sd)
    model.to(device)
    state.step = PARITY_STEP
    with plain_sig() if plain else contextlib.nullcontext():
        state, metrics = step(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.detach() for k, p in state.model.named_parameters()})


def phase_split_parity(device, smi: str) -> dict:
    """One f32 step of each phase with the sig kernel vs one with the plain composition,
    from one init and batch at step PARITY_STEP; the bf16 step's loss against the f32 one."""
    x = next(demon_batches(ST_BATCH, ST_HEIGHT, ST_WIDTH, device, seed=SEED + 3))
    pair_sd = copy.deepcopy(DepthPoseNet(
        generator=torch.Generator().manual_seed(SEED)).state_dict())
    coarse_net = DepthPoseNet().to(device)
    coarse_net.load_state_dict(pair_sd)
    batches = {"pair": x,
               "single": next(split_training.single_batches(coarse_net, iter([x])))}
    sds = {"pair": pair_sd, "single": copy.deepcopy(DispNet(
        DispNetVariant.depth4(), in_channels=4,
        generator=torch.Generator().manual_seed(SEED)).state_dict())}
    out = {}
    for phase in ("pair", "single"):
        kernel, plain, kernel_bf16 = (
            _parity_run(phase, sds[phase], batches[phase], device, dt, plain)
            for dt, plain in ((torch.float32, False), (torch.float32, True),
                              (torch.bfloat16, False)))
        out[phase] = _compare_steps(
            f"split_training {phase} at step {PARITY_STEP}",
            {"kernel": kernel, "plain": plain, "kernel_bf16": kernel_bf16}, 2e-4, smi)
    return out


def sig_bound(calls: list, backward: bool) -> tuple:
    """Least time (ms) an H100 SXM needs for sig calls ``[(pred, gt, deltas), ...]``:
    pred and gt read once (8 B a pixel) forward; pred and gt read and d pred written
    (12 B a pixel) backward, the label taking no gradient. Operations: ~15 float32 a term
    forward (per map a difference, two abs, two adds and a quotient, then the difference,
    its square and the sum) and ~24 backward (the term's two quotients once, its scale and
    the derivatives at both of its ends for d pred), plus ~2 a pixel (eps and the root,
    or the cotangent quotient), counting the terms that lie inside the map."""
    pixels = terms = 0
    for pred, _, deltas in calls:
        B, H, W, _ = pred.shape
        pixels += B * H * W
        terms += sum(B * (H * max(W - d, 0) + max(H - d, 0) * W) for d in deltas)
    nbytes = pixels * (12 if backward else 8)
    ops = terms * (24 if backward else 15) + 2 * pixels
    t_bytes, t_ops = nbytes / PEAK_HBM, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _time_sig(calls: list, coefs: list) -> dict:
    """ms of the forward alone and of the forward and backward (d pred, as the loss
    needs) over ``calls`` [(pred, gt, deltas)] (one set of deltas), three ways: ``group``,
    one group call as the pipelines make it; ``loop``, the same kernels called once a pair
    (``sig_l2_fused``, the pipelines' earlier call pattern); ``plain``, the plain
    composition pair by pair."""
    leaves = [p.detach().clone().requires_grad_(True) for p, _, _ in calls]
    gts, deltas = [g for _, g, _ in calls], calls[0][2]
    ways = {"group": lambda ps: sig_l2_fused_group(ps, gts, deltas, coefs)[0],
            "loop": lambda ps: sum(c * sig_l2_fused(p, g, deltas)
                                   for c, p, g in zip(coefs, ps, gts)),
            "plain": lambda ps: sig_l2_plain_group(ps, gts, deltas, coefs)[0]}
    return _time_ways(ways, [p for p, _, _ in calls], leaves)


def phase_sig_times(device, smi: str) -> dict:
    """The sig kernels against the plain composition three ways (``_time_sig``), beside
    the bound: phase 2's four pairs of a step (the main path's shapes) and the 5-delta
    192x256 B=8 call."""
    cases = sig_cases(device)
    rows = {}
    for label, names in (("phase-2 step, 4 pairs", [f"phase2 s{s}" for s in range(4)]),
                         ("5-delta 192x256 B=8", ["full_scales B=8"])):
        calls = [(cases[n][0], cases[n][2], cases[n][3]) for n in names]
        r = _time_sig(calls, [SIG_COEF] * len(calls))
        bf, by = sig_bound(calls, False)
        bb, by_bwd = sig_bound(calls, True)
        # forward+backward: the larger part names what bounds the pair
        r.update(bound_fwd=bf, bound_bwd=bb, bound_by=by_bwd if bb >= bf else by)
        rows[label] = r
        print(f"time sig_l2, {label}: forward group {r['group_fwd']:.4f} ms, per-pair loop "
              f"{r['loop_fwd']:.4f} ms, plain {r['plain_fwd']:.4f} ms, bound {bf:.5f} ms "
              f"({by}); forward+backward group {r['group_fwdbwd']:.4f} ms, per-pair loop "
              f"{r['loop_fwdbwd']:.4f} ms, plain {r['plain_fwdbwd']:.4f} ms, bound "
              f"{bf + bb:.5f} ms ({r['bound_by']}); turns {_turns(r)} [{smi}]")
    return rows


def phase_split_times(device, smi: str) -> dict:
    """ms/step of each phase's bf16 step with the sig kernel and with the plain
    composition, in turns (plain, kernel, kernel, plain) on one state and batch; then
    the launches a step of each from ``profile_step``."""
    out = {}
    for config in ("split_pair", "split_single"):
        _, state, step, batch = profile_step.CONFIGS[config](None, None, None, device, "kernel")
        times = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            with plain_sig() if name == "plain" else contextlib.nullcontext():
                times[name].append(time_ms(lambda: step(state, batch), 5))
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            out[(config, name)] = {"ms": ms}
            print(f"time training step bf16 {config} ({ST_HEIGHT}x{ST_WIDTH}, B={ST_BATCH}) "
                  f"sig={name}: {ms:.2f} ms/step (turns {', '.join(f'{t:.2f}' for t in ts)})"
                  f" [{smi}]")
    for config in ("split_pair", "split_single"):
        for name in ("kernel", "plain"):
            prof = profile_step.profile(steps=1, device=device, config=config, sig=name,
                                        top=0)
            sig_ms = kind_ms(prof, "sig kernels", 2 if name == "kernel" else 0)
            out[(config, name)].update(launches=prof["launches"],
                                       kernel_ms=prof["kernel_ms"], sig_ms=sig_ms)
            print(f"profile {config} sig={name}: {prof['launches']} launches, "
                  f"{prof['kernel_ms']:.2f} ms of device time a step, sig kernels "
                  f"{fmt_ms(sig_ms)} [{smi}]")
    return out


def euler_warp_coords(B: int, H: int, W: int, device, seed: int,
                      fmt: str = "euler") -> torch.Tensor:
    """The coords of config 3's warp: a seeded depth in [0.8, 2.5], an Euler pose of up
    to 5 cm and 0.02 rad, DeMoN-like intrinsics, through ``fmt="euler"``; with
    ``fmt="angleaxis"`` the L/R family's warp, the last three entries a rotation vector."""
    g = np.random.RandomState(seed)
    depth = torch.from_numpy(g.uniform(0.8, 2.5, (B, H, W)).astype(np.float32))
    pose = torch.from_numpy(np.concatenate([g.uniform(-0.05, 0.05, (B, 3)),
                                            g.uniform(-0.02, 0.02, (B, 3))], -1)
                            .astype(np.float32))
    K = torch.tensor([[0.89 * W, 0.0, W / 2], [0.0, 1.19 * H, H / 2], [0.0, 0.0, 1.0]])
    img = torch.zeros((B, H, W, 1), device=device)
    return projective_inverse_warp(img, depth.to(device), pose.to(device),
                                   K.expand(B, 3, 3).contiguous().to(device),
                                   fmt=fmt).coords


def fused_cases(device) -> dict:
    """name -> (imgs in [0, 255], coords, eligible): config 3's four scale shapes (B=16,
    C=3) with the coords of a real Euler warp, a 16x24 image at 24x16 coords (the same
    product), halves and integers reaching past every border, NaN and infinite coords,
    and B=10 (outside the rule)."""
    g = np.random.RandomState(SEED + 20)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    cases = {}
    for s in range(4):
        h, w = C3_HEIGHT >> s, C3_WIDTH >> s
        cases[f"config3 s{s}"] = (t(g.rand(C3_BATCH, h, w, 3) * 255),
                                  euler_warp_coords(C3_BATCH, h, w, device, SEED + 21 + s),
                                  True)
    cases["same product 16x24 at 24x16"] = (t(g.rand(C3_BATCH, 16, 24, 3) * 255),
                                            t(g.uniform(-3, 27, (C3_BATCH, 24, 16, 2))), True)
    cases["past every border"] = (t(g.rand(8, 12, 20, 3) * 255), t(np.round(g.uniform(
        [-2.5, -2.5], [22.5, 14.5], (8, 12, 20, 2)) * 2) / 2), True)
    coords = g.uniform(-2, 14, (8, 12, 20, 2))
    coords.reshape(-1)[g.choice(coords.size, 60, replace=False)] = np.repeat(
        [np.nan, np.inf, -np.inf], 20)
    cases["NaN and inf coords"] = (t(g.rand(8, 12, 20, 3) * 255), t(coords), True)
    cases["B=10 (outside the rule)"] = (t(g.rand(10, 24, 32, 3) * 255),
                                        euler_warp_coords(10, 24, 32, device, SEED + 25),
                                        False)
    return cases


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN (NaN payloads aside)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def phase_fused_sampler(device, smi: str) -> dict:
    """The fused sampler group on a config-3 step's 4 warps (``group_check``, without and
    with dimgs); then bilinear_sample_fused vs the plain version on single calls: the
    forward (out and wmask bit-equal), the launches (on the fused route, or on the
    sampler's own outside the rule), dcoords and dimgs against autograd of the plain
    version, and the same bits twice."""
    worst = {"out": 0.0, "wmask": 0.0, "dcoords": 0.0, "dimgs": 0.0}
    cases = fused_cases(device)
    warps = [(*cases[f"config3 s{s}"][:2], True) for s in range(4)]
    for dimgs in (False, True):
        errs = group_check("bilinear_sample_fused_group, a config-3 step",
                           bilinear_sample_fused_group, warps, (0, 0, 1, 1), smi, dimgs=dimgs)
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
    for name, (imgs, coords, eligible) in cases.items():
        g = np.random.RandomState(SEED + 26)
        dout = torch.from_numpy(g.randn(*coords.shape[:3], 3).astype(np.float32)).to(device)
        dmask = torch.from_numpy(g.randn(*coords.shape[:3], 1).astype(np.float32)).to(device)
        runs = []
        for fn in (bilinear_sample_fused, bilinear_sample_fused, bilinear_sample_reference):
            ti, tc = imgs.clone().requires_grad_(True), coords.clone().requires_grad_(True)
            before = read_counts()
            out, mask = fn(ti, tc)
            torch.autograd.backward([out, mask], [dout, dmask])
            after = read_counts()
            if fn is bilinear_sample_fused:
                got = tuple(after[k] - before[k] for k in SAMPLER_COUNTS)
                if got != ((0, 0, 1, 1) if eligible else (1, 1, 0, 0)):
                    raise AssertionError(f"fused sampler {name}: launches "
                                         f"{dict(zip(SAMPLER_COUNTS, got))}")
            runs.append((out.detach(), mask.detach(), tc.grad, ti.grad))
        (o1, m1, dc1, di1), (o2, m2, dc2, _), (ro, rm, rdc, rdi) = runs
        if not (_same_bits(o1, o2) and _same_bits(m1, m2) and _same_bits(dc1, dc2)):
            raise AssertionError(f"fused sampler {name}: two runs differ")
        fwd_errs = {"out": (o1 - ro).abs().nan_to_num().max().item(),
                    "wmask": (m1 - rm).abs().nan_to_num().max().item()}
        if not (_same_bits(o1, ro) and _same_bits(m1, rm)):
            raise AssertionError(f"fused sampler {name}: forward differs from the plain "
                                 f"version by {fwd_errs} (out, wmask)")
        for what, err in fwd_errs.items():
            worst[what] = max(worst[what], err)
        for what, a, r in (("dcoords", dc1, rdc), ("dimgs", di1, rdi)):
            torch.testing.assert_close(a, r, equal_nan=True, **TOL_DCOORDS,
                                       msg=lambda m: f"fused sampler {name} {what}: {m}")
            err = (a - r).abs().nan_to_num().max().item()
            worst[what] = max(worst[what], err)
        print(f"kernel bilinear_sample_fused {name} {tuple(imgs.shape)} at "
              f"{tuple(coords.shape)}: {'fused route' if eligible else 'sampler route'}; "
              f"out and wmask bit-equal to the plain version (abs err {fwd_errs['out']:.1e}, "
              f"{fwd_errs['wmask']:.1e}); dcoords abs err max "
              f"{(dc1 - rdc).abs().nan_to_num().max().item():.3e}, dimgs "
              f"{(di1 - rdi).abs().nan_to_num().max().item():.3e} vs autograd of the plain "
              f"version (rtol {TOL_DCOORDS['rtol']:.0e}, atol {TOL_DCOORDS['atol']:.2e}); "
              f"two runs bit-equal [{smi}]")
    return worst


def _counting(batches, log: list):
    """``batches`` unchanged, the launch counts appended to ``log`` before each is taken
    (so after each step but the last)."""
    for b in batches:
        log.append(read_counts(sync=False))
        yield b


def _per_step(log: list, end: dict) -> list:
    marks = log[1:] + [end]
    return [{k: b[k] - a[k] for k in a} for a, b in zip(log, marks)]


def phase_depth_then_cam(device, root: str, *, height: int = C3_HEIGHT,
                         width: int = C3_WIDTH, batch: int = C3_BATCH,
                         steps: int = C3_STEPS, dtype: str = "bfloat16",
                         smi: str = "") -> dict:
    """Config 3 for ``steps`` steps through the CLI's ``train`` on synthetic DeMoN
    batches, with the launch counts of each step; every loss component finite; the
    checkpoint read back into the full-resolution DepthPoseNet with a finite eval
    forward. Returns the per-step counts, the seconds and the checkpoint's variables."""
    ckpt = os.path.join(root, "depth_then_cam")
    args = depth_then_cam.parse_args([
        "--checkpoint_dir", ckpt, "--image_height", str(height), "--image_width",
        str(width), "--batch_size", str(batch), "--max_steps", str(steps),
        "--summary_freq", "1", "--save_latest_freq", str(steps), "--dtype", dtype,
        "--device", str(device), "--seed", str(SEED)])
    log: list = []
    t0 = time.perf_counter()
    state, _ = depth_then_cam.train(args, depth_then_cam.loss_weights(args),
                                    depth_then_cam.make_state(args),
                                    _counting(demon_batches(batch, height, width, device), log))
    per_step = _per_step(log, read_counts())
    seconds = time.perf_counter() - t0
    records = _records(ckpt, ("total", "pixel", "smooth", "exp"))
    if state.step != steps or len(records) != steps:
        raise AssertionError(f"depth_then_cam: step {state.step}, records {records}")
    for r, n in zip(records, per_step):
        print(f"depth_then_cam step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.4f}" for k in ("total", "pixel", "smooth", "exp"))
            + f"; launches {n} [{smi}]")
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    model = depth_pose_from_variables(variables, device=device)
    x = next(demon_batches(batch, height, width, device, seed=SEED + 4))
    with torch.no_grad():
        disps, pose, masks = model(x["image_pair"].permute(0, 3, 1, 2))
    shapes = [(batch, 1, height >> s, width >> s) for s in range(4)]
    if not model.full_resolution or [tuple(d.shape) for d in disps] != shapes \
            or not all(bool(torch.isfinite(o).all()) for o in (*disps, pose, *masks)):
        raise AssertionError(f"depth_then_cam checkpoint step {meta.get('step')}: "
                             f"{[tuple(d.shape) for d in disps]} or non-finite")
    print(f"depth_then_cam: {steps} steps of config 3 ({dtype}, {height}x{width}, batch "
          f"{batch}) through the CLI's train in {seconds:.1f} s host clock; every loss "
          f"component finite; model-{steps}.npz read back into the full-resolution "
          f"DepthPoseNet, eval forward finite [{smi}]")
    return {"per_step": per_step, "seconds": seconds, "variables": variables}


def _compare_steps(label: str, runs: dict, lr: float, smi: str, total: str = "total",
                   loss_rtol: float = TOL_STEP["loss_rtol"]) -> dict:
    """Hold ``runs["kernel"]`` to ``runs["plain"]`` (one f32 step each: (metrics,
    parameters)) and, where given, ``runs["kernel_bf16"]``'s ``total`` to the f32 one, at
    ``loss_rtol``, TOL_STEP and TOL_BF16_LOSS."""
    (lk, pk), (lp, pp) = runs["kernel"], runs["plain"]
    loss_err = max(_rel(lk[k], lp[k]) for k in lp)
    off = n = 0
    worst = 0.0
    for k in pp:
        diff = (pk[k] - pp[k]).abs()
        worst = max(worst, diff.max().item())
        off += int((diff > TOL_STEP["param_atol"]).sum())
        n += diff.numel()
    bf16 = runs.get("kernel_bf16")
    bf16_err = _rel(bf16[0][total], lp[total]) if bf16 else 0.0
    print(f"step parity f32 {label}, kernels vs plain: " + ", ".join(
        f"{k} {lk[k]:.6f}/{lp[k]:.6f}" for k in lp)
        + f"; loss components rel err max {loss_err:.2e} (tolerance "
        f"{loss_rtol:.0e}); params after Adam: max abs diff {worst:.2e} "
        f"(tolerance 2 lr = {2 * lr:.0e}), {off} of {n} ({off / n:.4%}) beyond "
        f"{TOL_STEP['param_atol']:.0e} (tolerance {TOL_STEP['param_share_off']:.0%})"
        + (f"; bf16 {total} {bf16[0][total]:.4f} vs f32 {lp[total]:.4f}, rel "
           f"{bf16_err:.2e} (tolerance {TOL_BF16_LOSS})" if bf16 else "") + f" [{smi}]")
    if loss_err > loss_rtol or worst > 2 * lr * (1 + 1e-4) \
            or off / n >= TOL_STEP["param_share_off"] or bf16_err > TOL_BF16_LOSS:
        raise AssertionError(f"{label} step parity beyond its tolerances")
    return {"loss_rel_err": loss_err, "param_share_off": off / n, "bf16_rel": bf16_err}


def phase_depth_then_cam_parity(device, smi: str) -> dict:
    """One f32 config-3 step with the kernels (fused sampler, smoothness) against one with
    their plain versions, from one init and batch; the bf16 step's loss against the f32."""
    batch = next(demon_batches(C3_BATCH, C3_HEIGHT, C3_WIDTH, device, seed=SEED + 5))
    sd = copy.deepcopy(DepthPoseNet(full_resolution=True,
                                    generator=torch.Generator().manual_seed(SEED)).state_dict())
    w = dataclasses.replace(LossWeights.depth_then_cam(), height=C3_HEIGHT, width=C3_WIDTH)
    runs = {}
    for name, sampler, dtype in (("kernel", "fused", torch.float32),
                                 ("plain", "xla", torch.float32),
                                 ("kernel_bf16", "fused", torch.bfloat16)):
        model = DepthPoseNet(full_resolution=True, dtype=dtype)
        model.load_state_dict(sd)
        state = create_train_state(model.to(device))
        step = make_depth_then_cam_step(dataclasses.replace(w, sampler=sampler))
        with plain_smoothness() if name == "plain" else contextlib.nullcontext():
            state, metrics = step(state, batch)
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.detach() for k, p in state.model.named_parameters()})
    return _compare_steps("config 3", runs, 2e-4, smi)


def phase_eval_harness(device, root: str, variables: dict, *, height: int = C3_HEIGHT,
                       width: int = C3_WIDTH, batch: int = C3_BATCH,
                       n: int = EVAL_BATCHES, dtype: str = "bfloat16",
                       smi: str = "") -> dict:
    """The eval harness's two nets through its functions on ``n`` batches of synthetic
    DeMoN scenes, the pair net restored from ``variables`` (config 3's checkpoint, stored
    as ``model_pairdepth``), the single net from its seeded init; the launch counts set to
    0 before each net and read after. Returns net -> (means, counts)."""
    pair_dir = os.path.join(root, "eval_pair")
    os.makedirs(pair_dir, exist_ok=True)
    save_variables_npz(os.path.join(pair_dir, f"{eval_harness.PAIR_GROUP}-1.npz"), variables)
    out = {}
    for net in ("pair", "single"):
        args = eval_harness.parse_args([
            "--net", net, "--checkpoint_dir", pair_dir, "--checkpoint_dir_single",
            os.path.join(root, "eval_single"), "--image_height", str(height),
            "--image_width", str(width), "--batch_size", str(batch), "--eval_batches",
            str(n), "--dtype", dtype, "--device", str(device), "--seed", str(SEED)])
        single = eval_harness.single_model(args) if net == "single" else None
        fn = eval_harness.make_eval_fn(eval_harness.loss_weights(args),
                                       eval_harness.pair_model(args), single)
        t0 = time.perf_counter()
        reset_counts()  # a main path: the eval harness, one net
        means = eval_harness.evaluate(fn, demon_batches(batch, height, width, device,
                                                        seed=SEED + 6), n)
        counts = read_counts()
        seconds = time.perf_counter() - t0
        if not means or not all(np.isfinite(v) for v in means.values()):
            raise AssertionError(f"eval harness --net {net}: {means}")
        print(f"eval harness --net {net}: {n} batches of {batch} at {height}x{width} "
              f"({dtype}) in {seconds:.2f} s host clock, every mean finite; sig launches "
              f"{counts['sig_fwd']} + {counts['sig_bwd']} [{smi}]")
        out[net] = (means, counts)
    return out


def phase_pair_serving(device, variables: dict, *, height: int = C3_HEIGHT,
                       width: int = C3_WIDTH, batch: int = C3_BATCH,
                       dtype: torch.dtype = torch.bfloat16, smi: str = "") -> dict:
    """PairPredictor (``dtype``, the folded forward) over ``batch + 1`` frames (``batch``
    pairs: the left images of synthetic DeMoN scenes) of the DepthPoseNet in
    ``variables``: config 3's full-resolution checkpoint, or split_training's truncated
    phase-1 checkpoint (the net ``infer/cli.py --mode pair`` serves), whose batch
    statistics their steps moved; the depth and pose held against the f32 module forward
    at TOL_SERVING; frames/s of ``4 * batch`` pairs of float32 frames, as the CLI reads
    them."""
    scenes = next(demon_batches(batch + 1, height, width, device, seed=SEED + 7))
    frames = scenes["image_pair"][..., :3].cpu().numpy()
    pairs = torch.from_numpy(np.concatenate([frames[:-1], frames[1:]], -1)).to(device)
    model = depth_pose_from_variables(variables, device=device)
    with torch.no_grad():
        disps, pose, _ = model(pairs.permute(0, 3, 1, 2).float())
    ref_z, ref_pose = disps[0][:, 0].cpu().numpy(), pose[:, 0].cpu().numpy()
    full = model.full_resolution
    net = "full-resolution" if full else "truncated"
    pred = PairPredictor(variables["params"], variables["batch_stats"], height=height,
                         width=width, full_resolution=full, batch_size=batch,
                         dtype=dtype, device=device)
    z, p = pred.predict_pairs(frames)
    scale = 1 if full else 4
    if not pred.uses_fast_path or z.shape != (batch, height // scale, width // scale) \
            or p.shape != (batch, 6) or not (np.isfinite(z).all() and np.isfinite(p).all()):
        raise AssertionError(f"pair serving {net}: fast path {pred.uses_fast_path}, shapes "
                             f"{z.shape} {p.shape} or non-finite")
    errs = {"depth": np.abs(z - ref_z), "pose": np.abs(p - ref_pose)}
    for what, diff in errs.items():
        if diff.max() > TOL_SERVING[0] or diff.mean() > TOL_SERVING[1]:
            raise AssertionError(f"pair serving {net} {what}: abs err max {diff.max()}, "
                                 f"mean {diff.mean()} to the f32 module forward beyond "
                                 f"{TOL_SERVING}")
    many = _frames(4 * batch + 1, height, width, seed=SEED + 9).astype(np.float32)
    pred.predict_pairs(many)                       # warm-up
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict_pairs(many)
    seconds = time.perf_counter() - t0
    fps = 4 * batch / seconds
    print(f"pair serving {net}: PairPredictor {str(dtype)[6:]} (folded forward) {batch} "
          f"pairs at {height}x{width}: depth abs err max {errs['depth'].max():.3e}, mean "
          f"{errs['depth'].mean():.3e}; pose max {errs['pose'].max():.3e}, mean "
          f"{errs['pose'].mean():.3e} to the f32 module forward (tolerance max "
          f"{TOL_SERVING[0]:.1e}, mean {TOL_SERVING[1]:.1e}); {4 * batch} pairs in "
          f"{seconds * 1e3:.1f} ms host clock, {fps:.1f} frames/s [{smi}]")
    return {"depth_max": float(errs["depth"].max()), "frames_per_s": fps}


def phase_fused_times(device, smi: str) -> dict:
    """A config-3 step's 4 warps three ways (one fused group call, the same kernels once a
    warp, the plain version) and ``grid_sample``, forward and forward + backward (dcoords,
    as the step needs it), twice in turns, beside the bound (``tools/sampler_units.py``)."""
    warps = sampler_units.units(device)["config 3"]
    row = sampler_units.time_unit(warps, sampler_units.ways("config 3"))
    sampler_units.report("config 3", warps, row, "bilinear_sample_fused", smi)
    return row


def phase_depth_then_cam_times(device, smi: str) -> dict:
    """ms/step of the bf16 config-3 step with the fused sampler and with the plain one, in
    turns (plain, kernel, kernel, plain; 5 steps a turn) on one state and batch; then the
    launches a step of each from ``profile_step``."""
    w, state, kernel_step, batch = profile_step.CONFIGS["depth_then_cam"](
        None, None, None, device, "kernel")
    steps = {"kernel": kernel_step,
             "plain": make_depth_then_cam_step(dataclasses.replace(w, sampler="xla"))}
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(time_ms(lambda: steps[name](state, batch), 5))
    out = {}
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        out[name] = {"ms": ms}
        print(f"time training step bf16 config 3 ({C3_HEIGHT}x{C3_WIDTH}, B={C3_BATCH}) "
              f"sampler={name}: {ms:.2f} ms/step (turns {', '.join(f'{t:.2f}' for t in ts)}; "
              f"spread {max(ts) - min(ts):.2f} ms), {C3_BATCH / ms * 1e3:.1f} frames/s [{smi}]")
    del state
    for name in ("kernel", "plain"):
        prof = profile_step.profile(steps=1, device=device, config="depth_then_cam",
                                    sampler=name, top=0)
        out[name].update(launches=prof["launches"], kernel_ms=prof["kernel_ms"],
                         sampler_ms=kind_ms(prof, "sampler kernels",
                                            2 if name == "kernel" else 0))
    return out


# ---- the tensor-core probes (kernels #6 and #7) -------------------------------------

def bf16_rtol(K: int) -> float:
    """The bf16 probes' limit, relative to max |plain|: the tensor cores add each 16-deep
    step of a product into the float32 sum with round-toward-zero alignment and
    normalisation (Fasi et al., "Numerical behavior of NVIDIA tensor cores", 2021), up to
    ~2 ulp a step and K / 16 steps a product; twice that for the plain float32 product's
    own rounding. 3.1e-5 at K = 1024, 1.2e-4 at K = 4096; a lost 64-byte stage of K
    moves a value by 1/32 (K = 1024) or 1/128 (K = 4096)."""
    return 4 * (K // 16) * 2.0 ** -23


def probe_cases(device, shapes: dict = None) -> dict:
    """(kernel name, dtype) -> (wrapper, plain version, a, b, extra args), the probes'
    operands (``tools/common.py:inputs``) at ``shapes`` (name -> (M, K, N, repeats))."""
    shapes = shapes or PROBE_SHAPES
    fns = {"dot_loop": (dot_loop, dot_loop_reference), "dot_grid": (dot_grid,
                                                                   dot_grid_reference)}
    cases = {}
    for name, (M, K, N, R) in shapes.items():
        x = probe_inputs(M, K, N, device=device)
        extra = (R,) if name == "dot_loop" else ()
        for dt, a, b in (("int8", x["a8"], x["b8"]), ("bf16", x["abf"], x["bbf"])):
            cases[(name, dt)] = (*fns[name], a, b, extra)
    return cases


def _kernel_label(mangled: str) -> str:
    """A readable name for a kernel of the probe, tail, loss or sampler libraries:
    dot_kernel's element type (int8 reads B^T, bf16 B), tile width and loop or grid; the
    transpose and reduce kernels; the loss and sampler kernels; the tail's bf16
    (tensor-core) and f32 kernels."""
    m = re.search(r"dot_kernelI(13__nv_bfloat16|a)Li(\d+)ELb([01])E", mangled)
    if m:
        return (f"dot_kernel<{'bf16' if m.group(1) != 'a' else 'int8'}, BN={m.group(2)}, "
                f"{'loop' if m.group(3) == '1' else 'grid'}>")
    for kind in ("transpose_kernel", "reduce_kernel"):
        if kind in mangled:
            return f"{kind}<{mangled.split(kind + 'I', 1)[1][:1]}>"
    m = re.search(r"(smooth|sig|bilinear)_group_(forward|backward)", mangled)
    if m:
        return m.group(0)
    if "tail_bf16_kernel" in mangled:
        return "tail_bf16_kernel"
    if "fused_tail_kernel" in mangled:
        return "fused_tail_kernel<f32>"
    return mangled


def sass_counts(name: str) -> dict:
    """``cuobjdump -sass`` on the built library ``name``: label -> each kernel's count of
    ``SASS_OPS``, and its registers and spills from nvcc's ``-Xptxas -v`` lines, printed."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    entry = _build.build(name)
    sass = subprocess.run([cuobjdump, "-sass", entry["path"]], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    regs, fn = {}, None
    for line in entry["log"].splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and "spill stores" in line:
            regs[fn] = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = [re.search(r"Used (\d+) registers", line).group(1)] + regs.get(fn, [])
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = block.split("\n", 1)[0].strip()
        counts = {op: len(re.findall(rf"\b{op}\b", block)) for op in SASS_OPS}
        label = _kernel_label(mangled)
        r = regs.get(mangled, ["?", "?", "?"])
        print(f"sass {name} {label}: " + ", ".join(f"{k} {v}" for k, v in counts.items())
              + f"; {r[0]} registers, {r[1] if len(r) > 1 else '?'} bytes spill stores, "
              f"{r[2] if len(r) > 2 else '?'} bytes spill loads")
        out[label] = counts
    return out


def hold_tail_sass(counts: dict) -> None:
    """Raise unless the tail's bf16 kernel runs its products on wgmma (HGMMA), loads x2
    through the TMA (UTMALDG) and holds no mma.sync (HMMA). The f32 kernel is listed, not
    held: it runs on the CUDA cores by design."""
    got = counts.get("tail_bf16_kernel")
    if got is None:
        raise AssertionError(f"fused_tail: no bf16 kernel among {sorted(counts)}")
    if not got["HGMMA"] or not got["UTMALDG"] or got["HMMA"]:
        raise AssertionError(f"fused_tail: tail_bf16_kernel is not wgmma fed by TMA: {got}")


def phase_sass() -> dict:
    """``sass_counts`` of the ``dot_grid``, ``dot_loop``, ``fused_tail``, ``smoothness``,
    ``sig_l2`` and ``bilinear_sample`` libraries. Raises unless each probe library's bf16
    products run on HGMMA and its int8 products on IGMMA, each product kernel loads through
    UTMALDG, and neither probe library holds an HMMA or IMMA (wmma's mma.sync); and unless
    ``hold_tail_sass`` passes. The loss and sampler kernels are listed with their
    registers and spills, not held. Returns (library, label) -> counts."""
    out = {}
    for name in ("dot_grid", "dot_loop"):
        kinds = set()
        for label, counts in sass_counts(name).items():
            if counts["HMMA"] or counts["IMMA"]:
                raise AssertionError(f"{name}: {label} holds mma.sync: {counts}")
            if label.startswith("dot_kernel"):
                dtype = "bf16" if "bf16" in label else "int8"
                wgmma = counts["HGMMA" if dtype == "bf16" else "IGMMA"]
                if not wgmma or not counts["UTMALDG"]:
                    raise AssertionError(f"{name}: {label} is not wgmma fed by TMA: {counts}")
                kinds.add(dtype)
            out[(name, label)] = counts
        if kinds != {"bf16", "int8"}:
            raise AssertionError(f"{name}: product kernels for {sorted(kinds)} only")
    tail = sass_counts("fused_tail")
    hold_tail_sass(tail)
    out.update({("fused_tail", label): counts for label, counts in tail.items()})
    for name in ("smoothness", "sig_l2", "bilinear_sample"):
        out.update({(name, label): counts for label, counts in sass_counts(name).items()})
    return out


def phase_probes(device, shapes: dict = None) -> dict:
    """dot_loop and dot_grid against their plain versions at the probes' shapes, int8
    and bf16: int8 bit-equal, bf16 within ``bf16_rtol(K)`` of max |plain|, the JAX probes'
    scalar (the float32 sum) likewise; on a card one product launch a call, a transpose
    of B before an int8 one, and for the loop one sum of its K parts after it (K = 1024
    is 8 or 16 stages of 128 bytes, split into 2 or 4 parts); a shape off the tile
    raises. Returns (kernel, dtype) -> max abs err."""
    launches = 1 if torch.device(device).type == "cuda" else 0
    errs = {}
    for (name, dt), (fn, ref, a, b, extra) in probe_cases(device, shapes).items():
        before = (fn.launches, fn.transposes, getattr(fn, "reduces", 0))
        got = fn(a, b, *extra)
        calls = fn.launches - before[0]
        more = (fn.transposes - before[1], getattr(fn, "reduces", 0) - before[2])
        want_more = (launches * int(dt == "int8"),
                     launches * int(name == "dot_loop"))
        want = ref(a, b, *extra)
        s_got, s_want = got.float().sum().item(), want.float().sum().item()
        err = (got.double() - want.double()).abs().max().item()
        top = want.double().abs().max().item()
        K = a.shape[1]
        if calls != launches or more != want_more:
            raise AssertionError(f"{name} {dt}: {calls} launches, (transposes, reduces) "
                                 f"{more} in one call, not {launches} and {want_more}")
        if dt == "int8":
            ok = torch.equal(got, want) and s_got == s_want
            limit = "bit-equal"
        else:
            tol = bf16_rtol(K)
            ok = err <= tol * top and abs(s_got - s_want) <= tol * abs(s_want)
            limit = f"max abs err <= {tol:.2e} x max |plain| = {tol * top:.3e}"
        print(f"kernel {name} {dt} {tuple(a.shape)} x {tuple(b.shape)}"
              f"{f' x {extra[0]} repeats' if extra else ''}: max abs err {err:.3e} "
              f"({err / top:.2e} of max |plain|), f32 sums {s_got:.9e} and {s_want:.9e}; "
              f"{limit}; {calls} launch, (transposes, reduces) {more}")
        if not ok:
            raise AssertionError(f"{name} {dt}: max abs err {err}, sums {s_got} and "
                                 f"{s_want}, beyond {limit}")
        errs[(name, dt)] = err
    for fn, tile in ((dot_loop, DOT_LOOP_TILE), (dot_grid, DOT_GRID_TILE)):
        a = torch.ones((tile[0] + 8, tile[2]), dtype=torch.int8, device=device)
        b = torch.ones((tile[2], tile[1]), dtype=torch.int8, device=device)
        before = (fn.launches, fn.transposes)
        try:
            fn(a, b)
        except ValueError as e:
            print(f"kernel {fn.__name__}: [{tile[0] + 8}, {tile[2]}] refused: {e}")
        else:
            raise AssertionError(f"{fn.__name__} took M = {tile[0] + 8}")
        if (fn.launches, fn.transposes) != before:
            raise AssertionError(f"{fn.__name__} launched on a refused shape")
    return errs


def phase_probe_tools() -> dict:
    """The probes' own entry points, ``tools/probe_int8_dot.py`` and
    ``tools/probe_int8_dot2.py`` (the main path of kernels #6 and #7): their printed
    lines, and the seconds a call of each case by the JAX probes' method."""
    return {"dot_loop": probe_int8_dot.main(), "dot_grid": probe_int8_dot2.main()}


def probe_bound(M: int, K: int, N: int, R: int, dtype: torch.dtype) -> tuple:
    """Least time (ms) an H100 SXM needs for R products of [M, K] . [K, N]: 2 R M N K
    operations at the int8 or bf16 tensor-core peak, or A and B read once and the int32 or
    float32 output written once."""
    esize = torch.tensor([], dtype=dtype).element_size()
    t_ops = 2.0 * R * M * N * K / (PEAK_INT8 if dtype == torch.int8 else PEAK_BF16)
    t_bytes = ((M * K + K * N) * esize + M * N * 4) / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def best_ms(fn, iters: int = 5, windows: int = 5) -> float:
    """The best of ``windows`` CUDA-event windows of ``iters`` calls (ms a call)."""
    return min(time_ms(fn, iters, warmup=1 if w else 2) for w in range(windows))


def phase_probe_times(device, smi: str) -> dict:
    """For each probe kernel and dtype: the kernel alone (best of 5 CUDA-event windows),
    its TOPS and share of the bound, the plain version, the library yardstick (one
    ``tools/common.py:library_product`` call for dot_grid, R in turn for dot_loop, as the
    JAX probe's ``make_xla``), the JAX-shaped call (kernel, float32 sum, ``.item()``, by
    ``tools/common.py:time_2arg``), and the int8 / bf16 ratios. Beside the int8 library
    call, another layout than the probes': ``torch._int_mm`` with B column-major
    (cuBLASLt's TN int8 layout, B made so outside the timed window)."""
    library = {"dot_loop": probe_int8_dot.library_loop,
               "dot_grid": lambda a, b: library_product(a.dtype)[0](a, b)}
    rows = {}
    for (name, dt), (fn, ref, a, b, extra) in probe_cases(device).items():
        M, K = a.shape
        N, R = b.shape[1], (extra[0] if extra else 1)
        ms = best_ms(lambda: fn(a, b, *extra))
        plain = best_ms(lambda: ref(a, b, *extra), iters=2, windows=2)
        lib = best_ms(lambda: library[name](a, b))
        shaped = time_2arg(lambda x, y: fn(x, y, *extra).float().sum(), a, b) * 1e3
        bound, by = probe_bound(M, K, N, R, a.dtype)
        tops = 2.0 * R * M * N * K / ms / 1e9
        rows[(name, dt)] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                            "bound_ms": bound, "bound_by": by, "jax_shaped_ms": shaped,
                            "tops": tops}
        layout = ""
        if dt == "int8":
            b_col = b.t().contiguous().t()  # another layout, made outside the timed window
            other = best_ms(lambda: library[name](a, b_col))
            rows[(name, dt)]["library_colmajor_ms"] = other
            layout = (f"; torch._int_mm with B column-major (another layout) {other:.4f} "
                      f"ms{' x R in turn' if R > 1 else ''}")
        print(f"time {name} {dt} ({M}x{K} . {K}x{N}, R={R}): kernel {ms:.4f} ms "
              f"({tops:.1f} T(FL)OP/s, {bound / ms * 100:.1f} % of the bound "
              f"{bound:.4f} ms, {by}), plain {plain:.4f} ms, library {lib:.4f} ms "
              f"({library_product(a.dtype)[1]}{' x R in turn' if R > 1 else ''}), "
              f"kernel + f32 sum + .item() {shaped:.4f} ms{layout} [{smi}]")
    for name in PROBE_SHAPES:
        k = rows[(name, "bf16")]["ms"] / rows[(name, "int8")]["ms"]
        lib = rows[(name, "bf16")]["library_ms"] / rows[(name, "int8")]["library_ms"]
        col = rows[(name, "bf16")]["library_ms"] / rows[(name, "int8")]["library_colmajor_ms"]
        print(f"time {name}: int8 / bf16 speed-up {k:.2f}x for the kernel, {lib:.2f}x for "
              f"the library, {col:.2f}x for the library with int8 B column-major (data "
              f"sheet: 1,979 / 989 = 2.00x) [{smi}]")
        rows[(name, "ratio")] = {"kernel": k, "library": lib, "library_colmajor": col}
    return rows


# ---- TurboDepthNet serving -------------------------------------------------------------

def turbo_hw(name: str) -> tuple:
    """(H, W) of a preset's committed weights: 240x720 for colon, 384x576 for the rest."""
    return (240, 720) if name == "colon" else (HEIGHT, WIDTH)


def turbo_weights(name: str) -> str:
    H, W = turbo_hw(name)
    return os.path.join(ROOT, "weights", f"turbo_{name}_distilled_{W}x{H}.npz")


def warmed_variables(model: torch.nn.Module, inputs: torch.Tensor) -> dict:
    """``model``'s JAX variables tree with its running statistics the batch statistics of
    ``inputs`` (one train-mode pass at decay 0): a fold then meets statistics that are not
    the init's zeros and ones."""
    model = model.to(inputs.device)
    for m in model.modules():
        if isinstance(m, SlimBatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        model.train()(inputs.float())
    return module_variables(model)


def seeded_turbo_variables(variant: TurboVariant, frames: torch.Tensor,
                           seed: int = SEED) -> dict:
    """A seeded init of ``variant`` warmed on ``frames`` (``warmed_variables``)."""
    return warmed_variables(
        TurboDepthNet(variant, generator=torch.Generator().manual_seed(seed)), frames)


def phase_turbo_parity(device, hw=turbo_hw, batch: int = 2) -> dict:
    """``fast_turbo_forward`` (BN folded) against the module's eval ``full_only`` forward
    for each of the nine presets, float32, at rtol = atol = TOL_FORWARD: the committed
    weights where the tree has them, else a seeded init with set statistics."""
    worst = {}
    for name in TurboVariant.PRESETS:
        v, (H, W) = TurboVariant.by_name(name), hw(name)
        frames = torch.from_numpy(_frames(batch, H, W, seed=SEED + 11)).to(device)
        path = turbo_weights(name)
        if os.path.exists(path):
            variables, source = load_variables_npz(path)[0], os.path.relpath(path, ROOT)
        else:
            variables, source = seeded_turbo_variables(v, frames), "seeded init"
        with torch.inference_mode():
            got = fast_turbo_forward(variables, frames, v, dtype=torch.float32,
                                     device=device)
            (ref,) = turbo_from_variables(variables, v, device=device)(frames,
                                                                       full_only=True)
        if got.shape != (batch, H, W, 1) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"turbo-{name}: shape {tuple(got.shape)} or non-finite")
        err = (got - ref).abs().max().item()
        if not torch.allclose(got, ref, rtol=TOL_FORWARD, atol=TOL_FORWARD):
            raise AssertionError(f"turbo-{name}: fast forward max abs err {err} beyond "
                                 f"rtol = atol = {TOL_FORWARD}")
        worst[name] = err
        print(f"turbo forward f32 {name} {H}x{W} B={batch} ({source}): fast_turbo_forward "
              f"matches the module's full_only forward, max abs err {err:.3e} (rtol = atol "
              f"= {TOL_FORWARD})")
    return worst


def phase_turbo_serving(device, smi: str = "", height: int = HEIGHT, width: int = WIDTH,
                        batch: int = 8, bench_batch: int = TURBO_BENCH_BATCH) -> dict:
    """TurboPredictor (bf16, the folded forward) over the committed turbo-small weights
    answers requests of ``batch`` (at least 5), 5 and 1 uint8 frames, each held against
    the f32 module forward at TOL_TURBO_SERVING; then frames/s of the bf16 folded
    forward at ``bench_batch`` on frames already on the device, and of the predictor from
    host frames. No kernel of this package lies on this path (cuDNN convolutions)."""
    variables, meta = load_variables_npz(TURBO_WEIGHTS)
    v = TurboVariant.by_name(meta["variant"])
    frames = _frames(batch, height, width, seed=SEED + 12)
    with torch.inference_mode():
        model = turbo_from_variables(variables, v, device=device)
        ref = model(torch.from_numpy(frames).to(device), full_only=True)[0][..., 0]
        ref = ref.cpu().numpy()
    pred = TurboPredictor(variables["params"], variables["batch_stats"], variant=v,
                          height=height, width=width, batch_size=batch,
                          dtype=torch.bfloat16, device=device)
    full = None
    for n in (batch, 5, 1):
        t0 = time.perf_counter()
        out = pred.predict_array(frames[:n])
        ms = (time.perf_counter() - t0) * 1e3
        if out.shape != (n, height, width) or not np.isfinite(out).all():
            raise AssertionError(f"turbo serving {n} frames: shape {out.shape} or "
                                 f"non-finite")
        diff = np.abs(out - ref[:n])
        err, mean = float(diff.max()), float(diff.mean())
        if err > TOL_TURBO_SERVING[0] or mean > TOL_TURBO_SERVING[1]:
            raise AssertionError(f"turbo serving {n} frames: abs err max {err}, mean "
                                 f"{mean} to the f32 module forward beyond "
                                 f"{TOL_TURBO_SERVING}")
        full = out if full is None else full
        if n < batch and 1 << (n - 1).bit_length() == batch:
            pad_diff = float(np.abs(out - full[:n]).max())
            if pad_diff != 0.0:
                raise AssertionError(f"turbo serving {n} frames differs from the full "
                                     f"batch by {pad_diff}")
        print(f"turbo serving ({meta['variant']}, {os.path.relpath(TURBO_WEIGHTS, ROOT)}): "
              f"{n} frames -> {out.shape} float32, finite, range [{out.min():.3f}, "
              f"{out.max():.3f}], {ms:.1f} ms host clock, abs err max {err:.3e}, mean "
              f"{mean:.3e} to the f32 module forward (tolerance max "
              f"{TOL_TURBO_SERVING[0]:.1e}, mean {TOL_TURBO_SERVING[1]:.1e}); no kernel of "
              f"this package on this path")
    many = _frames(bench_batch, height, width, seed=SEED + 13)
    folded = fold_turbo(variables, dtype=torch.bfloat16, device=device)
    x = torch.from_numpy(many).to(device)
    cuda = torch.device(device).type == "cuda"
    with torch.inference_mode():
        fwd = lambda: folded_turbo_forward(folded, x, v)
        if cuda:
            ms = time_ms(fwd, 5)
        else:
            fwd()
            t0 = time.perf_counter()
            fwd()
            ms = (time.perf_counter() - t0) * 1e3
    bench = TurboPredictor(variables["params"], variables["batch_stats"], variant=v,
                           height=height, width=width, batch_size=bench_batch,
                           dtype=torch.bfloat16, device=device)
    bench.predict_array(many)                              # warm-up
    t0 = time.perf_counter()
    bench.predict_array(many)
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"time turbo-{v.name} bf16 {height}x{width} B={bench_batch}: folded forward "
          f"{ms:.3f} ms/batch, {bench_batch / ms * 1e3:.1f} frames/s "
          f"({'CUDA events' if cuda else 'host clock'}); TurboPredictor from uint8 host "
          f"frames {host_ms:.1f} ms host clock, {bench_batch / host_ms * 1e3:.1f} frames/s "
          f"[{smi}]")
    return {"frames": batch + 5 + 1, "ms": ms, "frames_per_s": bench_batch / ms * 1e3,
            "host_frames_per_s": bench_batch / host_ms * 1e3}

def _write_jpegs(directory: str, n: int, height: int, width: int, seed: int) -> str:
    import PIL.Image as pil

    os.makedirs(directory, exist_ok=True)
    for i, img in enumerate(_frames(n, height, width, seed=seed)):
        pil.fromarray(img).save(os.path.join(directory, f"f{i:03d}.jpg"))
    return directory


def serve_checkpoint(device, ckpt: str, frames: str, mode: str, *, height: int, width: int,
                     batch: int, dtype: str = "bfloat16", extra=(), smi: str = "") -> dict:
    """``infer/cli.py --mode <mode> --checkpoint_dir <ckpt>`` over the JPEGs of ``frames``
    at ``height`` x ``width``: one dump a frame, each of the output size and finite."""
    out_dir = os.path.join(os.path.dirname(frames), f"served_{mode}_{os.path.basename(ckpt)}")
    t0 = time.perf_counter()
    written = infer_cli.main([
        "--mode", mode, "--checkpoint_dir", ckpt, "--dataset_dir", frames,
        "--output_dir", out_dir, "--image_height", str(height), "--image_width", str(width),
        "--batch_size", str(batch), "--dtype", dtype, "--device", str(device),
        "--out_height", str(height), "--out_width", str(width), *extra])
    seconds = time.perf_counter() - t0
    n = len(os.listdir(frames))
    dumps = [np.fromfile(p, np.float32) for p in written]
    if len(written) != n or any(d.shape != (height * width,) or not np.isfinite(d).all()
                                for d in dumps):
        raise AssertionError(f"serving {ckpt} ({mode}): {len(written)} dumps of {n} frames, "
                             f"shapes {[d.shape for d in dumps]} or non-finite values")
    print(f"checkpoint serving: infer/cli.py --mode {mode} --checkpoint_dir "
          f"{os.path.basename(ckpt)} {' '.join(extra)} wrote {n} finite {height}x{width} "
          f"dumps in {seconds:.1f} s host clock, range [{min(d.min() for d in dumps):.3f}, "
          f"{max(d.max() for d in dumps):.3f}] [{smi}]")
    return {"frames": n, "seconds": seconds}


def phase_distill(device, root: str, *, height: int = HEIGHT, width: int = WIDTH,
                  batch: int = DISTILL_BATCH, steps: int = DISTILL_STEPS,
                  val_check: int = DISTILL_VAL_CHECK, variant: str = "base",
                  dtype: str = "bfloat16", smi: str = "") -> dict:
    """The distillation CLI (``distill_turbo.py``'s ``main``) for ``steps`` steps with a
    validation every ``val_check``: the committed depth4 teacher as ``model-0.npz`` of a
    teacher directory, a turbo student of ``variant`` on the synthetic frames. The launch
    counts are set to 0 just before and read just after (returned as ``counts``). Every
    record finite; ``turbo-<steps>.npz`` read back into the student, whose eval forward
    is finite; then ``infer/cli.py --mode turbo --checkpoint_dir`` serves frames from it."""
    teacher_dir = os.path.join(root, "teacher")
    os.makedirs(teacher_dir, exist_ok=True)
    shutil.copyfile(TEACHER, os.path.join(teacher_dir, "model-0.npz"))
    ckpt = os.path.join(root, "checkpoints_distill")
    reset_counts()  # a main path: distillation
    t0 = time.perf_counter()
    state, _ = distill_turbo.main([
        "--teacher_checkpoint_dir", teacher_dir, "--checkpoint_dir", ckpt,
        "--turbo_variant", variant, "--image_height", str(height), "--image_width",
        str(width), "--batch_size", str(batch), "--max_steps", str(steps),
        "--summary_freq", "1", "--validation_check", str(val_check),
        "--save_latest_freq", str(steps), "--dtype", dtype, "--device", str(device),
        "--seed", str(SEED)])
    counts = read_counts()
    seconds = time.perf_counter() - t0
    if state.step != steps:
        raise AssertionError(f"distillation stopped at step {state.step}")
    val = _train_records(ckpt, steps, val_check, ("total_loss",) + tuple(
        f"distill_l1_s{s}" for s in range(4)), ("mae_vs_teacher", "absrel_vs_teacher"),
        "distill", smi)
    v = TurboVariant.by_name(variant)
    variables, _ = load_variables_npz(os.path.join(ckpt, f"turbo-{steps}.npz"))
    student = turbo_from_variables(variables, v, device=device)
    with torch.no_grad():
        outs = student(torch.from_numpy(_frames(2, height, width)).to(device))
    shapes = [(2, height >> s, width >> s, 1) for s in range(4)]
    if [tuple(o.shape) for o in outs] != shapes or not all(
            bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"distilled turbo-{variant}: {[tuple(o.shape) for o in outs]}")
    print(f"distill: {steps} steps of turbo-{variant} from the depth4 teacher ({dtype}, "
          f"{height}x{width}, batch {batch}) and {len(val)} validations through the CLI in "
          f"{seconds:.1f} s host clock; every record finite; turbo-{steps}.npz read back "
          f"into TurboDepthNet({variant}), eval forward finite; launches {counts} [{smi}]")
    frames = _write_jpegs(os.path.join(root, "frames_distill"), 3, height, width, SEED + 20)
    reset_counts()
    served = serve_checkpoint(device, ckpt, frames, "turbo", height=height, width=width,
                              batch=batch, dtype=dtype, extra=("--turbo_variant", variant),
                              smi=smi)
    if any(read_counts().values()):
        raise AssertionError(f"turbo serving launched {read_counts()}")
    return {"steps": steps, "validations": len(val), "counts": counts,
            "seconds": seconds, "served": served["frames"]}


def _distill_run(device, teacher_vars: dict, sd: dict, images: torch.Tensor,
                 dtype: torch.dtype, tail: str, variant: str):
    """One distill step of a turbo student from the state dict ``sd``; (metrics,
    parameters)."""
    student = TurboDepthNet(TurboVariant.by_name(variant), dtype=dtype)
    student.load_state_dict(sd)
    state = create_train_state(student.to(device))
    teacher = folded_teacher(teacher_vars, dtype=dtype, tail=tail, device=device)
    state, metrics = make_distill_step(teacher)(state, images)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.detach() for k, p in state.model.named_parameters()})


def phase_distill_parity(device, smi: str = "", height: int = HEIGHT, width: int = WIDTH,
                         batch: int = DISTILL_BATCH, variant: str = "base") -> dict:
    """One f32 distill step with the teacher's fused tail against one with the native
    tail (the plain chain of layers), from one student init and batch: the loss components
    within TOL_DISTILL_LOSS, the parameters as TOL_STEP holds them; the bf16 step's total
    against the f32 one."""
    teacher_vars, _ = load_variables_npz(TEACHER)
    sd = copy.deepcopy(TurboDepthNet(TurboVariant.by_name(variant),
                                     generator=torch.Generator().manual_seed(SEED)).state_dict())
    images = torch.from_numpy(_frames(batch, height, width, seed=SEED + 21)).to(device).float()
    runs = {name: _distill_run(device, teacher_vars, sd, images, dt, tail, variant)
            for name, dt, tail in (("kernel", torch.float32, "fused"),
                                   ("plain", torch.float32, "native"),
                                   ("kernel_bf16", torch.bfloat16, "fused"))}
    return _compare_steps(f"distillation (turbo-{variant}, {height}x{width}, B={batch}), "
                          f"teacher tail fused vs native", runs, 2e-4, smi,
                          total="total_loss", loss_rtol=TOL_DISTILL_LOSS)


def phase_distill_times(device, smi: str) -> dict:
    """ms/step of the bf16 distill step (turbo-base, 576x384, B=8) and of the teacher's
    frozen forward timed alone on the same images (fused tail; the native tail beside it),
    CUDA events, in turns; ``teacher_alone_over_step`` is the ratio of the two loops, not
    a share measured inside the step."""
    teacher_vars, _ = load_variables_npz(TEACHER)
    student = TurboDepthNet(TurboVariant.base(), generator=torch.Generator().manual_seed(SEED),
                            dtype=torch.bfloat16)
    state = create_train_state(student.to(device))
    images = torch.from_numpy(_frames(DISTILL_BATCH, HEIGHT, WIDTH, seed=SEED + 22))
    images = images.to(device).float()
    teachers = {tail: folded_teacher(teacher_vars, dtype=torch.bfloat16, tail=tail,
                                     device=device) for tail in ("fused", "native")}
    step = make_distill_step(teachers["fused"])
    times = {"step": [], "teacher": [], "teacher_native": []}
    for _ in range(2):
        times["step"].append(time_ms(lambda: step(state, images), 10))
        with torch.no_grad():
            times["teacher"].append(time_ms(lambda: teachers["fused"](images), 10))
            times["teacher_native"].append(time_ms(lambda: teachers["native"](images), 10))
    out = {k: sum(v) / len(v) for k, v in times.items()}
    out["teacher_alone_over_step"] = out["teacher"] / out["step"]
    print(f"time distill step bf16 turbo-base {HEIGHT}x{WIDTH} B={DISTILL_BATCH}: "
          f"{out['step']:.2f} ms/step (turns {', '.join(f'{t:.2f}' for t in times['step'])}), "
          f"{DISTILL_BATCH / out['step'] * 1e3:.1f} frames/s; the teacher's forward timed "
          f"alone (fused tail) {out['teacher']:.2f} ms, "
          f"{out['teacher_alone_over_step']:.1%} of the step's time; "
          f"with the native tail {out['teacher_native']:.2f} ms (CUDA events) [{smi}]")
    return out


def phase_depth_only_turbo(device, dataset: str, *, height: int = C2_HEIGHT,
                           width: int = C2_WIDTH, batch: int = C2_BATCH,
                           steps: int = C2_STEPS, val_check: int = C2_VAL_CHECK,
                           variant: str = "colon", dtype: str = "bfloat16",
                           smi: str = "") -> dict:
    """The config-2 CLI with ``--turbo <variant>`` for ``steps`` steps with a validation
    every ``val_check``, the launch counts set to 0 just before and read just after
    (``counts``); every record finite; then the ``model`` checkpoint served by
    ``infer/cli.py --mode turbo --checkpoint_group model``."""
    root = os.path.dirname(dataset)
    ckpt = os.path.join(root, "checkpoints_depth_only_turbo")
    reset_counts()  # a main path: depth_only --turbo
    t0 = time.perf_counter()
    state, _ = depth_only.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--batch_size", str(batch),
        "--max_steps", str(steps), "--summary_freq", "1", "--save_latest_freq", str(steps),
        "--validation_check", str(val_check), "--image_height", str(height),
        "--image_width", str(width), "--dtype", dtype, "--device", str(device),
        "--seed", str(SEED), "--turbo", variant])
    counts = read_counts()
    seconds = time.perf_counter() - t0
    if state.step != steps or not isinstance(state.model, TurboDepthNet):
        raise AssertionError(f"depth_only --turbo: step {state.step}, {type(state.model)}")
    val = _train_records(ckpt, steps, val_check, ("total", "depth", "smooth"),
                         ("total", "si_log_rmse", "smooth"), "depth_only --turbo", smi)
    print(f"depth_only --turbo {variant}: {steps} steps ({dtype}, {height}x{width}, batch "
          f"{batch}) and {len(val)} validations through the CLI in {seconds:.1f} s host "
          f"clock; every record finite; launches {counts} [{smi}]")
    frames = _write_jpegs(os.path.join(root, "frames_turbo"), 3, height, width, SEED + 23)
    reset_counts()
    served = serve_checkpoint(device, ckpt, frames, "turbo", height=height, width=width,
                              batch=batch, dtype=dtype, smi=smi, extra=(
                                  "--checkpoint_group", "model", "--turbo_variant", variant))
    if any(read_counts().values()):
        raise AssertionError(f"turbo serving launched {read_counts()}")
    return {"steps": steps, "validations": len(val), "counts": counts, "seconds": seconds,
            "served": served["frames"]}


def phase_depth_checkpoint_serving(device, ckpt: str, *, height: int = C2_HEIGHT,
                                   width: int = C2_WIDTH, batch: int = 8, n: int = 12,
                                   dtype: str = "bfloat16", smi: str = "") -> dict:
    """``infer/cli.py --mode depth --checkpoint_dir`` over ``n`` frames (at most 4
    batches: one chunk of the predictor), the launch counts set to 0 just before and read
    just after: one fused_tail launch a batch."""
    if n > 4 * batch:
        raise ValueError(f"{n} frames are more than one chunk of {4 * batch}")
    frames = _write_jpegs(os.path.join(os.path.dirname(ckpt), "frames_depth"), n, height,
                          width, SEED + 24)
    reset_counts()  # a main path: depth serving from a checkpoint directory
    served = serve_checkpoint(device, ckpt, frames, "depth", height=height, width=width,
                              batch=batch, dtype=dtype, smi=smi)
    counts = read_counts()
    return {"batches": -(-n // batch), "counts": counts, **served}


def phase_device_cache(device, smi: str = "", n: int = CACHE_FRAMES, height: int = HEIGHT,
                       width: int = WIDTH, batch: int = DISTILL_BATCH,
                       steps: int = 3) -> dict:
    """A seeded uint8 corpus of ``n`` frames in a ``DeviceCache`` on ``device``, gathered
    at ``batch`` with mirror and rot180 bits for ``steps`` batches: each gathered batch
    bit-equal to the same gather in numpy; the gather's time (CUDA events on the card)."""
    frames = _frames(n, height, width, seed=SEED + 25)
    cache = DeviceCache({"image": frames}, float_keys=("image",), aug_keys=("image",),
                        device=device)
    flips = rots = 0
    for idx, flip, rot in cache.index_stream(batch, seed=SEED, augment=True,
                                             num_steps=steps):
        got = cache.gather(idx, flip=flip, rot=rot)["image"]
        want = frames[idx].astype(np.float32)
        want = np.where(flip[:, None, None, None], want[:, :, ::-1], want)
        want = np.where(rot[:, None, None, None], want[:, ::-1, ::-1], want)
        if got.dtype != torch.float32 or not torch.equal(got.cpu(), torch.from_numpy(want)):
            raise AssertionError(f"DeviceCache gather of {idx.tolist()} (flip "
                                 f"{flip.tolist()}, rot {rot.tolist()}) differs from numpy's")
        flips, rots = flips + int(flip.sum()), rots + int(rot.sum())
    ms = None
    if torch.device(device).type == "cuda":
        idx, flip, rot = next(cache.index_stream(batch, seed=SEED + 1, augment=True))
        ms = time_ms(lambda: cache.gather(idx, flip=flip, rot=rot), 10)
    print(f"DeviceCache: {n} uint8 frames {height}x{width} ({cache.nbytes() / 1e6:.1f} MB) "
          f"on {device}; {steps} gathers of {batch} with {flips} mirrors and {rots} rot180s "
          f"bit-equal to numpy's; a gather of {batch} with its bits "
          + (f"{ms:.3f} ms (CUDA events)" if ms is not None else "not timed") + f" [{smi}]")
    return {"nbytes": cache.nbytes(), "ms": ms}


# ---- the DeMoN-stream families: config 5 and the symmetric L/R family ------------------

def lr_warps(device) -> list:
    """The 16 samplings of an L/R step as ``losses/pipelines.py:_lr_warps`` makes them
    (B=16, 192x256 down to 24x32): at each scale the right image (C=3, [0, 255]) at the
    left view's angle-axis warp coords, the left image at the right view's, and the right
    and left views' inverse depths (C=1, [0.2, 2]) at the same coords; dcoords on all 16,
    dimgs on the 8 inverse depths."""
    g = np.random.RandomState(SEED + 40)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    warps = []
    for s in range(4):
        h, w = LR_HEIGHT >> s, LR_WIDTH >> s
        left, right = (t(g.rand(LR_BATCH, h, w, 3) * 255) for _ in range(2))
        inv_l, inv_r = (t(g.uniform(0.2, 2.0, (LR_BATCH, h, w, 1))) for _ in range(2))
        c_l, c_r = (euler_warp_coords(LR_BATCH, h, w, device, SEED + 41 + 2 * s + k,
                                      fmt="angleaxis").contiguous() for k in range(2))
        warps += [(right, c_l, True, False), (left, c_r, True, False),
                  (inv_r, c_l, True, True), (inv_l, c_r, True, True)]
    return warps


def lr_group_bound(warps: list) -> tuple:
    """(forward ms, backward ms, "bytes" or "operations"): the least time an H100 SXM needs
    for the L/R group, counted as ``tools/sampler_units.py:unit_bound`` counts a unit, each
    input read once and each output written once: each distinct image and each distinct
    coords tensor read once each way (two members share each coords tensor, as in
    ``losses/pipelines.py:_lr_warps``), out and wmask forward, out's cotangent read and
    each distinct coords tensor's dcoords and each C=1 image's dimgs written once backward;
    ~(19 + 7 C) operations a target pixel forward, ~(39 + 8 C) backward."""
    times = []
    for backward in (False, True):
        nbytes = ops = 0
        seen = set()
        for imgs, coords, _, dimgs in warps:
            B, Hs, Ws, C = imgs.shape
            n = coords.shape[0] * coords.shape[1] * coords.shape[2]
            if imgs.data_ptr() not in seen:
                seen.add(imgs.data_ptr())
                nbytes += 4 * B * Hs * Ws * C * (2 if backward and dimgs else 1)
            if coords.data_ptr() not in seen:
                seen.add(coords.data_ptr())
                nbytes += 4 * 2 * n * (2 if backward else 1)
            nbytes += 4 * C * n if backward else 4 * (C + 1) * n
            ops += ((39 + 8 * C) if backward else (19 + 7 * C)) * n
        t_bytes, t_ops = nbytes / PEAK_HBM, ops / PEAK_F32
        times.append((max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"))
    (fwd, by_f), (bwd, by_b) = times
    return fwd, bwd, by_b if bwd >= fwd else by_f


def phase_lr_sampler(device, smi: str) -> dict:
    """``bilinear_sample_group`` on an L/R step's 16 samplings, 8 with C=3 and 8 with C=1,
    dimgs on the C=1 members (``group_check``): one launch each way, out and wmask
    bit-equal, dcoords and dimgs within TOL_DCOORDS. Then the group's forward and
    backward at seeded cotangents (dcoords on the 8 coords tensors, each shared by two
    members as in a step; dimgs on the C=1 members) and the plain version's, in turns (the
    ways in order, then reversed; CUDA events), the group's device time under
    ``torch.profiler`` where the session kept all its kernels, beside the bound. Returns
    the largest differences and the times."""
    warps = lr_warps(device)
    errs = group_check("bilinear_sample_group, an L/R step", bilinear_sample_group, warps,
                       (1, 1, 0, 0), smi)
    g = np.random.RandomState(SEED + 7)
    douts = [torch.from_numpy(g.randn(*w[1].shape[:3], w[0].shape[3]).astype(np.float32))
             .to(device) for w in warps]
    imgs = [w[0].clone().requires_grad_(w[3]) for w in warps]
    leaf = {}
    coords = [leaf.setdefault(w[1].data_ptr(), w[1].clone().requires_grad_(True))
              for w in warps]
    wrt = list(leaf.values()) + [i for i in imgs if i.requires_grad]
    ways = {"group": bilinear_sample_group, "plain": plain_group}

    def both(name):
        outs, _ = ways[name](imgs, coords)
        return torch.autograd.grad(outs, wrt, douts)

    order = list(ways)
    times = {k: [] for k in ways}
    for name in order + order[::-1]:
        times[name].append(time_ms(lambda: both(name), 10))
    out = dict(errs)
    out.update({name: {"ms": sum(ts) / len(ts), "turns": ts} for name, ts in times.items()})
    # the group's kernels, the dimgs buffer's zero fill and an add a shared coords tensor
    want = 2 + 1 + (len(warps) - len(leaf))
    sampler_units.spend_profiler_session(lambda: both("group"))
    dev, n = sampler_units.device_ms(lambda: both("group"))
    out["group"]["device_ms"] = dev if n == want else None
    fwd, bwd, by = lr_group_bound(warps)
    out.update(bound_ms=fwd + bwd, bound_by=by)
    print(f"time sampler group, an L/R step (16 samplings, dcoords on 8 coords tensors, "
          f"dimgs on 8), forward+backward: " + ", ".join(
              f"{k} {out[k]['ms']:.4f} ms (turns {', '.join(f'{t:.4f}' for t in times[k])})"
              for k in order) + f"; the group's device time "
          + (f"{dev:.4f} ms in {n} kernels" if n == want else
             f"not measured (the profiler session kept {n} of {want} kernels)")
          + f"; bound {fwd + bwd:.4f} ms ({by}) [{smi}]")
    return out


def _check_per_step(label: str, per_step: list, want: dict) -> None:
    """Every step's launch counts equal to ``want``, every other count 0."""
    for i, n in enumerate(per_step, start=1):
        if n != {k: want.get(k, 0) for k in n}:
            raise AssertionError(f"{label} step {i} launched {n}, not {want} and nothing "
                                 f"else")


def phase_on_demon(device, root: str, *, height: int = C5_HEIGHT, width: int = C5_WIDTH,
                   batch: int = C5_BATCH, steps: int = C5_STEPS, dtype: str = "bfloat16",
                   smi: str = "") -> dict:
    """Config 5 for ``steps`` steps through ``on_demon``'s ``train`` on synthetic DeMoN
    batches, with the launch counts of each step; every loss component finite; the
    checkpoint read back into the truncated DepthPoseNet with a finite eval forward.
    Returns the per-step counts, the seconds and the checkpoint's variables."""
    ckpt = os.path.join(root, "on_demon")
    args = on_demon.parse_args([
        "--checkpoint_dir", ckpt, "--image_height", str(height), "--image_width",
        str(width), "--batch_size", str(batch), "--max_steps", str(steps),
        "--summary_freq", "1", "--save_latest_freq", str(steps), "--dtype", dtype,
        "--device", str(device), "--seed", str(SEED)])
    log: list = []
    t0 = time.perf_counter()
    state, _ = on_demon.train(args, on_demon.loss_weights(args), on_demon.make_state(args),
                              _counting(demon_batches(batch, height, width, device), log))
    per_step = _per_step(log, read_counts())
    seconds = time.perf_counter() - t0
    records = _records(ckpt, ("total", "smooth", "depth"))
    if state.step != steps or len(records) != steps:
        raise AssertionError(f"on_demon: step {state.step}, records {records}")
    for r, n in zip(records, per_step):
        print(f"on_demon step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.4f}" for k in ("total", "smooth", "depth"))
            + f"; launches {n} [{smi}]")
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    model = depth_pose_from_variables(variables, device=device)
    x = next(demon_batches(batch, height, width, device, seed=SEED + 10))
    with torch.no_grad():
        disps, pose, masks = model(x["image_pair"].permute(0, 3, 1, 2))
    shapes = [(batch, 1, height >> s, width >> s) for s in (2, 3)]
    if model.full_resolution or [tuple(d.shape) for d in disps] != shapes \
            or not all(bool(torch.isfinite(o).all()) for o in (*disps, pose, *masks)):
        raise AssertionError(f"on_demon checkpoint step {meta.get('step')}: "
                             f"{[tuple(d.shape) for d in disps]} or non-finite")
    print(f"on_demon: {steps} steps of config 5 ({dtype}, {height}x{width}, batch {batch}) "
          f"through the CLI's train in {seconds:.1f} s host clock; every loss component "
          f"finite; model-{steps}.npz read back into the truncated DepthPoseNet, eval "
          f"forward finite [{smi}]")
    return {"per_step": per_step, "seconds": seconds, "variables": variables}


def phase_lr(device, root: str, mode: str, *, height: int = LR_HEIGHT, width: int = LR_WIDTH,
             batch: int = LR_BATCH, steps: int = LR_STEPS, dtype: str = "bfloat16",
             smi: str = "") -> dict:
    """``depth_then_cam_lr`` in ``mode`` (``lr_full``, or ``lr_gt``: ``--gt_pose``) for
    ``steps`` steps through the CLI's ``train`` on synthetic DeMoN batches, with the launch
    counts of each step; every loss component finite; the checkpoint read back into
    ``LRNet`` with a finite eval forward. Returns the per-step counts and the seconds."""
    gt_pose = LR_MODES[mode]
    ckpt = os.path.join(root, mode)
    args = depth_then_cam_lr.parse_args([
        "--checkpoint_dir", ckpt, "--image_height", str(height), "--image_width",
        str(width), "--batch_size", str(batch), "--max_steps", str(steps),
        "--summary_freq", "1", "--save_latest_freq", str(steps), "--dtype", dtype,
        "--device", str(device), "--seed", str(SEED)] + (["--gt_pose"] if gt_pose else []))
    log: list = []
    t0 = time.perf_counter()
    state, _ = depth_then_cam_lr.train(
        args, depth_then_cam_lr.loss_weights(args), depth_then_cam_lr.make_state(args),
        _counting(demon_batches(batch, height, width, device, seed=SEED + 11), log))
    per_step = _per_step(log, read_counts())
    seconds = time.perf_counter() - t0
    keys = ("total", "pixel", "smooth", "exp", "cam", "consist", "depth") \
        + (("sig",) if gt_pose else ())
    records = _records(ckpt, keys)
    if state.step != steps or len(records) != steps:
        raise AssertionError(f"{mode}: step {state.step}, records {records}")
    for r, n in zip(records, per_step):
        print(f"{mode} step {r['step']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in keys)
              + f"; launches {n} [{smi}]")
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    model = lrnet_from_variables(variables, device=device)
    x = next(demon_batches(batch, height, width, device, seed=SEED + 12))["image_pair"]
    with torch.no_grad():
        out = model(x[..., :3], x[..., 3:])
    tensors = [t for v in out.values() for t in (v if isinstance(v, list) else [v])]
    if model.with_single == gt_pose or tuple(out["pair_left"][0].shape) != \
            (batch, height, width, 1) or not all(bool(torch.isfinite(t).all())
                                                 for t in tensors):
        raise AssertionError(f"{mode} checkpoint step {meta.get('step')}: "
                             f"{sorted(out)} or non-finite")
    print(f"{mode}: {steps} steps ({dtype}, {height}x{width}, batch {batch}) through the "
          f"CLI's train in {seconds:.1f} s host clock; every loss component finite; "
          f"model-{steps}.npz read back into LRNet(with_single={not gt_pose}), eval forward "
          f"finite [{smi}]")
    return {"per_step": per_step, "seconds": seconds}


def _lr_cli(mode: str, dtype: str, device):
    """``depth_then_cam_lr``'s arguments in ``mode`` at the smoke's size, seed, ``dtype``
    and ``device``."""
    return depth_then_cam_lr.parse_args(
        ["--image_height", str(LR_HEIGHT), "--image_width", str(LR_WIDTH), "--batch_size",
         str(LR_BATCH), "--dtype", dtype, "--device", str(device), "--seed", str(SEED)]
        + (["--gt_pose"] if LR_MODES[mode] else []))


def _plain_terms(step):
    """``step`` with its smoothness and sig terms on their plain versions."""
    def run(state, batch):
        with plain_smoothness(), plain_sig():
            return step(state, batch)
    return run


def phase_lr_parity(device, smi: str) -> dict:
    """One f32 step of each L/R mode with the kernels (sampler, smoothness, sig) against
    one with their plain versions, from one init and batch; the bf16 step's total against
    the f32 one."""
    batch = next(demon_batches(LR_BATCH, LR_HEIGHT, LR_WIDTH, device, seed=SEED + 13))
    out = {}
    for mode in LR_MODES:
        runs = {}
        for name, dtype in (("kernel", "float32"), ("plain", "float32"),
                            ("kernel_bf16", "bfloat16")):
            args = _lr_cli(mode, dtype, device)
            w = depth_then_cam_lr.loss_weights(args)
            state = depth_then_cam_lr.make_state(args)  # one init: the seed's, f32 params
            if name == "plain":
                step = _plain_terms(depth_then_cam_lr.make_step(
                    args, dataclasses.replace(w, sampler="xla")))
            else:
                step = depth_then_cam_lr.make_step(args, w)
            state, metrics = step(state, batch)
            runs[name] = ({k: float(v) for k, v in metrics.items()},
                          {k: p.detach() for k, p in state.model.named_parameters()})
            del state
        out[mode] = _compare_steps(mode, runs, 2e-4, smi)
    return out


@contextlib.contextmanager
def sampled_outside(record: list):
    """Within the block each sampler group call of the loss pipelines first appends
    (target pixels whose sampling point lies outside its source image, NaN included;
    target pixels) to ``record``: a reading for the measurements only."""
    saved = pipelines.bilinear_sample_group

    def group(imgs, coords, *rest):
        with torch.no_grad():
            n_out = n = 0
            for im, c in zip(imgs, coords):
                x, y = c[..., 0], c[..., 1]
                inside = (x >= 0) & (x <= im.shape[2] - 1) & (y >= 0) & (y <= im.shape[1] - 1)
                n_out, n = n_out + int((~inside).sum()), n + inside.numel()
            record.append((n_out, n))
        return saved(imgs, coords, *rest)

    pipelines.bilinear_sample_group = group
    try:
        yield
    finally:
        pipelines.bilinear_sample_group = saved


def phase_demon_times(device, smi: str) -> dict:
    """ms/step of the bf16 config-5, ``lr_full`` and ``lr_gt`` steps (192x256, B=16) with
    the kernels, with every term on its plain version, and for the L/R modes with the
    plain sampler and the loss kernels (the ``sampler`` default's question), in turns of 5
    steps (the ways in order, then reversed) on one state and batch; then each config's
    launches, device time by kind and busy share a step from ``profile_step``, with the
    kernels and with the plain versions."""
    out = {}
    for config, (cli, flags) in profile_step.DEMON_CLIS.items():
        w, state, kernel_step, batch = profile_step.CONFIGS[config](
            None, None, None, device, "kernel")
        make = functools.partial(cli.make_step, cli.parse_args(list(flags)))
        plain_w = dataclasses.replace(w, sampler="xla")
        steps = {"kernel": kernel_step, "plain": _plain_terms(make(plain_w))}
        if config != "on_demon":
            steps["plain_sampler"] = make(plain_w)
            record: list = []
            with sampled_outside(record):  # the first step from the seeded init
                kernel_step(state, batch)
            n_out, n = map(sum, zip(*record))
            print(f"{config} step from the seeded init: {n_out} of {n} sampled target "
                  f"pixels ({n_out / n:.1%}) outside their source image [{smi}]")
            outside = n_out / n
        order = list(steps)
        times = {k: [] for k in steps}
        for name in order[::-1] + order:
            times[name].append(time_ms(lambda: steps[name](state, batch), 5))
        out[config] = {"outside": outside} if config != "on_demon" else {}
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            out[config][name] = {"ms": ms, "turns": ts}
            print(f"time training step bf16 {config} ({w.height}x{w.width}, "
                  f"B={LR_BATCH}) {name}: {ms:.2f} ms/step (turns "
                  f"{', '.join(f'{t:.2f}' for t in ts)}; spread {max(ts) - min(ts):.2f} ms), "
                  f"{LR_BATCH / ms * 1e3:.1f} frames/s [{smi}]")
        del state
        for name, way in (("kernel", "kernel"), ("plain", "plain")):
            prof = profile_step.profile(steps=3, device=device, config=config, sampler=way,
                                        smoothness=way, sig=way, top=0)
            out[config][name].update(
                launches=prof["launches"], kernel_ms=prof["kernel_ms"],
                busy=prof["kernel_ms"] / prof["wall_ms"], kinds=prof["kinds"],
                sampler_ms=kind_ms(prof, "sampler kernels",
                                   2 if way == "kernel" and config != "on_demon" else 0))
    return out


# ---- the colon-pair families: optflow_family's five modes and dim11 --------------------

def write_dim11_dataset(root: str, batch: int = OF_BATCH, hw=D11_HW) -> tuple:
    """The dim11 layout (ref ``imageselect_Dataloader_optflow_dim11.py``) of a synthetic
    colon pair dataset at ``hw`` with ``batch`` training pairs: each ``_cam.txt`` holds 6
    raw values, fx fy cx cy and 2 unused, and the depths lie in a directory of their own.
    Returns (the dataset's directory, the depths' directory)."""
    data = write_colon_pair_dataset(os.path.join(root, "dim11"), num_frames=2 * batch,
                                    H=hw[0], W=hw[1], seed=SEED + 1)
    depth_dir = os.path.join(root, "dim11_depth")
    os.makedirs(depth_dir)
    for name in sorted(os.listdir(os.path.join(data, "seq0"))):
        path = os.path.join(data, "seq0", name)
        if name.endswith("_cam.txt"):
            K = np.loadtxt(path, delimiter=",").reshape(3, 3)
            with open(path, "w") as f:
                f.write(" ".join(str(float(v)) for v in (K[0, 0], K[1, 1], K[0, 2],
                                                          K[1, 2], 0.0, 0.0)))
        elif name.endswith("_z.bin"):
            shutil.move(path, depth_dir)
    return data, depth_dir


@contextlib.contextmanager
def smooth_groups(record: list):
    """Within the block each smoothness group call of the loss pipelines first appends
    (maps, eligible C=1 maps) to ``record``: a reading of the group's make-up."""
    saved = pipelines.smoothness_fused_group

    def group(maps, coefs):
        record.append((len(maps), sum(m.shape[-1] == 1 and m.shape[1] >= 3
                                      and m.shape[2] >= 3 for m in maps)))
        return saved(maps, coefs)

    pipelines.smoothness_fused_group = group
    try:
        yield
    finally:
        pipelines.smoothness_fused_group = saved


def colon_cli(mode: str, device, dtype: str, *, batch: int = OF_BATCH,
              height: int = None, width: int = None, read_hw=OF_READ, steps: int = 1,
              dataset: str = "", depth_dir: str = None, ckpt: str = "") -> tuple:
    """(the CLI module, its arguments) of a colon-pair ``mode``: ``optflow_family --mode
    mode`` reading ``read_hw`` pairs resized to ``height`` x ``width`` (224x480 where None),
    or ``dim11`` at ``height`` x ``width`` (224x224)."""
    common = ["--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--batch_size",
              str(batch), "--max_steps", str(steps), "--summary_freq", "1",
              "--save_latest_freq", str(steps), "--dtype", dtype, "--device", str(device),
              "--seed", str(SEED)]
    if mode == "dim11":
        h, w = height or D11_HW[0], width or D11_HW[1]
        return dim11, dim11.parse_args(common + [
            "--image_height", str(h), "--image_width", str(w)]
            + (["--depth_dir", depth_dir] if depth_dir else []))
    h, w = height or OF_HEIGHT, width or OF_WIDTH
    return optflow_family, optflow_family.parse_args(common + [
        "--mode", mode, "--image_height", str(read_hw[0]), "--image_width", str(read_hw[1]),
        "--resized_height", str(h), "--resized_width", str(w)])


def phase_colon(device, root: str, mode: str, dataset: str, *, depth_dir: str = None,
                height: int = None, width: int = None, read_hw=OF_READ,
                batch: int = OF_BATCH, steps: int = OF_STEPS, dtype: str = "bfloat16",
                smi: str = "") -> dict:
    """A colon-pair ``mode`` for ``steps`` steps through its CLI's ``train`` and
    ``batches`` (the JPEG reader), with the launch counts of each step and the make-up of
    each smoothness group; every loss component finite; the checkpoint read back into its
    model (``dispnet_from_variables`` finds the variant, or the full-resolution
    DepthPoseNet) with a finite eval forward. Returns the per-step counts, the groups,
    the seconds and the checkpoint's variables."""
    ckpt = os.path.join(root, f"colon_{mode}")
    cli, args = colon_cli(mode, device, dtype, batch=batch, height=height, width=width,
                          read_hw=read_hw, steps=steps, dataset=dataset,
                          depth_dir=depth_dir, ckpt=ckpt)
    log, groups = [], []
    t0 = time.perf_counter()
    with smooth_groups(groups):
        state, _ = cli.train(args, cli.loss_weights(args), cli.make_state(args),
                             _counting(cli.batches(args), log))
    per_step = _per_step(log, read_counts())
    seconds = time.perf_counter() - t0
    keys = [k for k in ("total", "depth", "smooth", "pixel", "optflow", "exp")
            if k in _records(ckpt, ("total",))[0]]
    records = _records(ckpt, keys)
    if state.step != steps or len(records) != steps:
        raise AssertionError(f"{mode}: step {state.step}, records {records}")
    for r, n, grp in zip(records, per_step, groups):
        print(f"{mode} step {r['step']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in keys)
              + f"; launches {n}; smoothness group {grp[0]} maps, {grp[1]} of them "
              f"eligible C=1 maps [{smi}]")
    variables, meta = load_variables_npz(os.path.join(ckpt, f"model-{steps}.npz"))
    w = cli.loss_weights(args)
    h, w = w.height, w.width
    x = next(iter(cli.batches(args)))
    pair = torch.cat([x["tgt_image"], x["src_image"]], -1).permute(0, 3, 1, 2)
    if mode == "dim11":
        model = depth_pose_from_variables(variables, device=device)
        with torch.no_grad():
            disps, pose, masks = model(pair)
        outs, want = [*disps, pose, *masks], model.full_resolution
    else:
        model = dispnet_from_variables(variables, device=device)
        _, variant, in_ch, _ = optflow_family.MODES[mode]
        with torch.no_grad():
            outs = model(pair if in_ch == 6 else pair[:, :3])
        want = model.variant == variant() and outs[0].shape == (
            batch, variant().head_channels, h, w)
    if not want or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"{mode} checkpoint step {meta.get('step')}: "
                             f"{[tuple(o.shape) for o in outs]} or non-finite")
    print(f"{mode}: {steps} steps ({dtype}, {h}x{w}, batch {batch}) through the CLI's "
          f"train in {seconds:.1f} s host clock; every loss component finite; "
          f"model-{steps}.npz read back, eval forward finite [{smi}]")
    return {"per_step": per_step, "groups": groups, "seconds": seconds,
            "variables": variables}


def phase_sfm_serving(device, variables: dict, *, height: int = OF_HEIGHT,
                      width: int = OF_WIDTH, batch: int = 8, smi: str = "") -> dict:
    """``DepthPredictor(variant=sfm)`` over the sfm mode's checkpoint: the module forward
    (``uses_fast_path`` false: linear 3-channel heads, nothing to fold) answers requests
    of ``batch``, 5 and 1 frames with channel 0, in bf16 (the default; finite, its
    difference from the f32 module printed) and in float32 (within phase 4's rtol = atol
    of the f32 module forward's channel 0)."""
    frames = _frames(batch, height, width)
    model = dispnet_from_variables(variables, device=device)
    with torch.no_grad():
        ref = model(torch.from_numpy(frames).to(device).permute(0, 3, 1, 2).float())[0]
    ref = ref[:, 0].cpu().numpy()
    ref = np.concatenate([ref, ref[:5], ref[:1]], 0)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        pred = DepthPredictor(variables["params"], variables["batch_stats"], height=height,
                              width=width, variant=DispNetVariant.sfm(), batch_size=batch,
                              dtype=dtype, device=device)
        if pred.uses_fast_path:
            raise AssertionError("DepthPredictor(variant=sfm) took the folded forward")
        got[dtype] = np.concatenate([pred.predict_array(frames[:n]) for n in (batch, 5, 1)])
        if got[dtype].shape != (batch + 6, height, width) or not np.isfinite(got[dtype]).all():
            raise AssertionError(f"sfm serving {dtype}: {got[dtype].shape} or non-finite")
    bf16 = np.abs(got[torch.bfloat16] - ref)
    f32_ok = np.allclose(got[torch.float32], ref, rtol=TOL_FORWARD, atol=TOL_FORWARD)
    print(f"serving sfm DispNet through DepthPredictor's module forward ({height}x{width}, "
          f"requests of {batch}, 5, 1, channel 0 of heads reaching "
          f"{float(np.abs(ref).max()):.3f}): bf16 finite, max abs err {bf16.max():.3e}, "
          f"mean {bf16.mean():.3e} to the f32 module forward; f32 within rtol = atol "
          f"{TOL_FORWARD:.0e} of it: {f32_ok} [{smi}]")
    if not f32_ok:
        raise AssertionError("sfm serving in float32 differs from the module forward")
    return {"frames": 2 * (batch + 6), "bf16_max_abs_err": float(bf16.max())}


def phase_colon_parity(device, smi: str) -> dict:
    """One f32 step of optflow_only (kernel #4 and #2), optflow3 (#2 on 12 channel views)
    and dim11 (#4 and #2 at 224x224 .. 28x28 on [-0.5, 0.5] pixels) with the kernels
    against one with the plain sampler and smoothness term, from one init (the CLI's
    seeded one) and batch (``profile_step``'s pair batch at 224x480, its dim11 batch at
    224x224; B=10); the bf16 total against the f32 one."""
    batches = {"optflow_only": profile_step.pair_batch(OF_BATCH, OF_HEIGHT, OF_WIDTH,
                                                       SEED + 20, device),
               "dim11": profile_step.dim11_batch(OF_BATCH, *D11_HW, SEED + 21, device)}
    batches["optflow3"] = batches["optflow_only"]
    out = {}
    for mode, batch in batches.items():
        runs = {}
        for name, dtype in (("kernel", "float32"), ("plain", "float32"),
                            ("kernel_bf16", "bfloat16")):
            cli, args = colon_cli(mode, device, dtype)
            w = cli.loss_weights(args)
            state = cli.make_state(args)
            if name == "plain":
                step = _plain_terms(cli.make_step(args, dataclasses.replace(w, sampler="xla")))
            else:
                step = cli.make_step(args, w)
            state, metrics = step(state, batch)
            runs[name] = ({k: float(v) for k, v in metrics.items()},
                          {k: p.detach() for k, p in state.model.named_parameters()})
            del state
        label = "dim11" if mode == "dim11" else f"optflow_family --mode {mode}"
        out[mode] = _compare_steps(label, runs, 2e-4, smi)
    return out


def phase_colon_times(device, smi: str) -> dict:
    """ms/step of the bf16 steps of COLON_TIMED with ``sampler="pallas"`` (the sampler
    kernels) and ``"xla"`` (the plain sampler), the loss kernels in both, on one state and
    batch in COLON_ROUNDS rounds of COLON_ROUND_STEPS steps each way, the first way
    alternating; each round's paired difference (kernel minus plain) and their median,
    the figure a preset's choice reads; then each one's launches, busy share and the
    device time a step of the smoothness kernels, and of the sampler kernels where the
    preset is "pallas", from ``profile_step``."""
    out = {}
    for config in COLON_TIMED:
        cli, flags = profile_step.COLON_CLIS[config]
        w, state, _, batch = profile_step.CONFIGS[config](None, None, None, device, "kernel")
        args = cli.parse_args(list(flags))
        steps = {s: cli.make_step(args, dataclasses.replace(w, sampler=s))
                 for s in ("pallas", "xla")}
        times = {k: [] for k in steps}
        for r in range(COLON_ROUNDS):
            for name in list(steps)[::1 - 2 * (r % 2)]:
                times[name].append(time_ms(lambda: steps[name](state, batch),
                                           COLON_ROUND_STEPS, warmup=1))
        del state
        B = batch["tgt_image"].shape[0]
        diffs = [p - x for p, x in zip(times["pallas"], times["xla"])]
        row = {"preset": w.sampler, "diffs": diffs,
               "median_diff": statistics.median(diffs)}
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            row[name] = {"ms": ms, "turns": ts}
            print(f"time training step bf16 {config} ({w.height}x{w.width}, B={B}) "
                  f"sampler={name}{' (the preset)' if name == w.sampler else ''}: "
                  f"{ms:.2f} ms/step (rounds {', '.join(f'{t:.2f}' for t in ts)}; "
                  f"spread {max(ts) - min(ts):.2f} ms), {B / ms * 1e3:.1f} frames/s [{smi}]")
        print(f"time {config}: paired differences pallas - xla "
              f"{', '.join(f'{d:+.2f}' for d in diffs)} ms; median {row['median_diff']:+.2f}, "
              f"mean {sum(diffs) / len(diffs):+.2f} ms/step [{smi}]")
        prof = profile_step.profile(steps=3, device=device, config=config, top=0)
        row.update(launches=prof["launches"], busy=prof["kernel_ms"] / prof["wall_ms"],
                   sampler_ms=kind_ms(prof, "sampler kernels") if w.sampler == "pallas"
                   else None, smooth_ms=kind_ms(prof, "smoothness kernels"))
        print(f"profile {config} (sampler={w.sampler}): {prof['kernel_ms']:.2f} ms of "
              f"kernels in {prof['launches']} launches a step (busy {row['busy']:.1%}), "
              f"sampler kernels {fmt_ms(row['sampler_ms'])}, smoothness kernels "
              f"{fmt_ms(row['smooth_ms'])} [{smi}]")
        out[config] = row
    return out


# ---- test-time refinement and the flow-augmented predictor ------------------------------

def refine_per_step(sampler: str) -> dict:
    """A refine step's launches on ``sampler``'s route: the smoothness group each way, and
    the sampler group each way ("pallas") or RF_WARPS plain samplings ("xla")."""
    if sampler == "pallas":
        return {**_SMOOTH, **_SAMPLE}
    return {**_SMOOTH, "plain_samples": RF_WARPS}


@contextlib.contextmanager
def refine_step_counts(log: list):
    """Within the block every step that ``infer/refine.py:make_refine_step`` makes appends
    the launch counts after it (synchronised) to ``log``."""
    saved = refine.make_refine_step

    def make(**weights):
        step = saved(**weights)

        def counted(state, inputs):
            out = step(state, inputs)
            log.append(read_counts())
            return out
        return counted

    refine.make_refine_step = make
    try:
        yield
    finally:
        refine.make_refine_step = saved


def phase_refine(device, root: str, *, hw=RF_HW, points: int = RF_POINTS,
                 steps: int = RF_STEPS, smi: str = "") -> dict:
    """Phase 40, a main path: ``infer/refine_cli.py`` for ``steps`` steps on a two-view
    COLMAP text model of one synthetic scene (``write_colmap_pair``: known depth and pose,
    ``points`` anchors projected from the depth) at ``hw``, the launch counts set to 0
    just before the CLI's ``main`` and read after each step; each step's smoothness
    groups' make-up; the ``.bin`` finite, positive and of H x W, the history finite with
    the scale > 0; its abs-rel error to the scene's depth printed. Returns the per-step
    counts, the groups, the history and the seconds."""
    h, w = hw
    scene = write_colmap_pair(root, h, w, num_points=points, seed=SEED)
    out_dir = os.path.join(root, "refined")
    log, groups = [], []
    reset_counts()   # a main path: refinement through its CLI
    t0 = time.perf_counter()
    with refine_step_counts(log), smooth_groups(groups):
        depth, hist = refine_cli.main([
            "--model_dir", scene["model_dir"], "--image_dir", scene["image_dir"],
            "--image1", "a.jpg", "--image2", "b.jpg", "--output_dir", out_dir,
            "--steps", str(steps), "--height", str(h), "--width", str(w),
            "--device", str(device)])
    seconds = time.perf_counter() - t0
    per_step = _per_step([{k: 0 for k in log[0]}] + log[:-1], log[-1])
    z = np.fromfile(os.path.join(out_dir, "a.jpg_refined_z.bin"), np.float32)
    recorded = 1 + steps // 100
    if (len(per_step) != steps or z.size != h * w or not np.isfinite(z).all()
            or not (z > 0).all() or len(hist["loss"]) != recorded
            or not np.isfinite(hist["loss"] + hist["scale"]).all()
            or min(hist["scale"]) <= 0):
        raise AssertionError(f"refinement: {len(per_step)} steps, .bin of {z.size} values "
                             f"(finite {np.isfinite(z).all()}), history {hist}")
    absrel = float(np.mean(np.abs(z.reshape(h, w) - scene["depth"]) / scene["depth"]))
    print(f"refinement: infer/refine_cli.py, {steps} f32 steps at {h}x{w}, B=1, "
          f"{points} anchors, sampler={refine.SAMPLER} (the preset) in {seconds:.1f} s "
          f"host clock; loss {hist['loss']}, scale {hist['scale']}; .bin of {z.size} "
          f"finite positive values, abs-rel {absrel:.4f} to the scene's depth; launches a "
          f"step {per_step[0]}, smoothness group {groups[0][0]} maps, {groups[0][1]} of them "
          f"eligible C=1 maps [{smi}]")
    return {"per_step": per_step, "groups": groups, "history": hist, "seconds": seconds,
            "absrel": absrel}


def refine_setup(device, hw=RF_HW, points: int = RF_POINTS) -> dict:
    """``refine_inputs`` of the phase-40 scene's pair, from ``colmap_pair_scene``."""
    scene = colmap_pair_scene(np.random.RandomState(SEED), *hw, points)
    return refine.refine_inputs(*scene["images"], scene["relative_pose"], scene["K"],
                                scene["sparse_xy"], scene["sparse_z"], device=device)


def phase_refine_parity(device, smi: str, hw=RF_HW) -> dict:
    """Phase 41: one f32 refine step with the kernels (the smoothness group and the
    sampler group on "pallas") against one with their plain versions (``"xla"`` and
    ``plain_smoothness``), from one init (``refine_state``'s seeded one) on the phase-40
    pair: the loss and the scale within TOL_STEP's rtol, the parameters within 2 lr."""
    inputs = refine_setup(device, hw)
    runs = {}
    for name, sampler in (("kernel", "pallas"), ("plain", "xla")):
        state = refine.refine_state(seed=SEED, learning_rate=RF_LR, device=device)
        step = refine.make_refine_step(sampler=sampler)
        if name == "plain":
            step = _plain_terms(step)
        state, metrics = step(state, inputs)
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.detach() for k, p in state.model.named_parameters()})
        del state
    return _compare_steps(f"refinement ({hw[0]}x{hw[1]}, B=1)", runs, RF_LR, smi)


def phase_refine_times(device, smi: str) -> dict:
    """Phase 42: ms/step of the f32 refine step with ``sampler="pallas"`` and ``"xla"``
    (the smoothness kernels in both) on one state and the phase-40 pair, in RF_ROUNDS
    rounds of RF_ROUND_STEPS steps each way, the first way alternating; each round's
    paired difference (kernel minus plain) and their median, the figure the preset's
    rule reads; then each route's device time of the smoothness and sampler kernels, its
    launches and busy share a step from ``profile_step``'s ``refine`` config."""
    inputs = refine_setup(device)
    state = refine.refine_state(seed=SEED, learning_rate=RF_LR, device=device)
    steps = {s: refine.make_refine_step(sampler=s) for s in ("pallas", "xla")}
    times = {k: [] for k in steps}
    for r in range(RF_ROUNDS):
        for name in list(steps)[::1 - 2 * (r % 2)]:
            times[name].append(time_ms(lambda: steps[name](state, inputs), RF_ROUND_STEPS,
                                       warmup=1))
    del state
    diffs = [p - x for p, x in zip(times["pallas"], times["xla"])]
    row = {"preset": refine.SAMPLER, "diffs": diffs,
           "median_diff": statistics.median(diffs)}
    for name, ts in times.items():
        row[name] = {"ms": sum(ts) / len(ts), "turns": ts}
        print(f"time refine step f32 ({RF_HW[0]}x{RF_HW[1]}, B=1) sampler={name}"
              f"{' (the preset)' if name == refine.SAMPLER else ''}: {row[name]['ms']:.3f} "
              f"ms/step (rounds {', '.join(f'{t:.3f}' for t in ts)}; spread "
              f"{max(ts) - min(ts):.3f} ms) [{smi}]")
    print(f"time refine: paired differences pallas - xla "
          f"{', '.join(f'{d:+.3f}' for d in diffs)} ms; median {row['median_diff']:+.3f}, "
          f"mean {sum(diffs) / len(diffs):+.3f} ms/step; the rule (median <= 0) picks "
          f"{'pallas' if row['median_diff'] <= 0 else 'xla'} [{smi}]")
    for way, sampler in (("kernel", "pallas"), ("plain", "xla")):
        prof = profile_step.profile(steps=3, device=device, config="refine", top=0,
                                    sampler=way)
        row[sampler].update(
            launches=prof["launches"], kernel_ms=prof["kernel_ms"],
            busy=prof["kernel_ms"] / prof["wall_ms"],
            smooth_ms=kind_ms(prof, "smoothness kernels"),
            sampler_ms=kind_ms(prof, "sampler kernels") if sampler == "pallas" else None)
        print(f"profile refine (sampler={sampler}): {prof['kernel_ms']:.3f} ms of kernels "
              f"in {prof['launches']} launches a step (busy {row[sampler]['busy']:.1%}), "
              f"smoothness kernels {fmt_ms(row[sampler]['smooth_ms'])}, sampler kernels "
              f"{fmt_ms(row[sampler]['sampler_ms'])} [{smi}]")
    return row


def flow_inputs(n: int, hw, seed: int = SEED + 30) -> np.ndarray:
    """[n, H, W, 11] flow-augmented inputs of synthetic scenes (target and source of
    ``make_pair_scene``) and seeded smooth flows, assembled as the predictor's
    ``assemble_input`` does."""
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        tgt, src, *_ = make_pair_scene(rng, h, w)
        coarse = rng.uniform(-3, 3, (h // 16 + 1, w // 16 + 1, 2))
        flow = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w].astype(np.float32)
        out.append(FlowAugmentedPredictor.assemble_input(tgt, src, flow))
    return np.stack(out)


def phase_flow_serving(device, *, hw=FLOW_HW, batch: int = FLOW_BATCH,
                       smi: str = "") -> dict:
    """Phase 43, a main path: ``FlowAugmentedPredictor`` answers requests of ``batch``, 5
    and 1 inputs of the truncated DepthPoseNet over 11 channels (a seeded init, its
    statistics warmed on FLOW_BATCH inputs, the first ``batch`` of which it serves)
    through the folded forward: in float32 within
    TOL_FORWARD of the f32 module forward, in bf16 (the default) within
    TOL_FLOW_SERVING of it; frames/s of 4 batches in bf16 by CUDA events (host clock on
    the CPU). The counts are set to 0 before the predictors are built and read after
    their requests (no kernel of this package is on this path)."""
    h, w = hw
    inputs = flow_inputs(max(batch, FLOW_BATCH), hw)   # the statistics see FLOW_BATCH
    x = torch.from_numpy(inputs).to(device)
    variables = warmed_variables(
        DepthPoseNet(in_channels=11, generator=torch.Generator().manual_seed(SEED)),
        x.permute(0, 3, 1, 2))
    inputs, x = inputs[:batch], x[:batch]
    model = depth_pose_from_variables(variables, device=device)
    with torch.no_grad():
        ref = model.forward_nhwc(x)[0][0][..., 0].cpu().numpy()
    ref = np.concatenate([ref, ref[:5], ref[:1]])
    reset_counts()   # a main path: flow-augmented serving
    gots, preds = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        pred = FlowAugmentedPredictor(variables["params"], variables["batch_stats"],
                                      height=h, width=w, batch_size=batch, dtype=dtype,
                                      device=device)
        got = np.concatenate([pred.predict(inputs[:n]) for n in (batch, 5, 1)])
        if not pred.uses_fast_path or got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"flow serving {dtype}: fast path {pred.uses_fast_path}, "
                                 f"{got.shape} or non-finite")
        gots[dtype], preds[dtype] = got, pred
    counts = read_counts()
    f32_err = np.abs(gots[torch.float32] - ref)
    f32_ok = np.allclose(gots[torch.float32], ref, rtol=TOL_FORWARD, atol=TOL_FORWARD)
    bf16 = np.abs(gots[torch.bfloat16] - ref)
    bf16_ok = bf16.max() <= TOL_FLOW_SERVING[0] and bf16.mean() <= TOL_FLOW_SERVING[1]
    many = np.concatenate([inputs] * 4)
    pred = preds[torch.bfloat16]
    pred.predict(many)   # warm-up
    if torch.device(device).type == "cuda":
        ms, clock = time_ms(lambda: pred.predict(many), 1, warmup=0), "CUDA events"
    else:
        t0 = time.perf_counter()
        pred.predict(many)
        ms, clock = (time.perf_counter() - t0) * 1e3, "host clock"
    fps = len(many) / ms * 1e3
    print(f"flow serving: FlowAugmentedPredictor (folded forward), requests of {batch}, 5, "
          f"1 at {h}x{w}x11 (disparities {float(ref.min()):.3f} .. "
          f"{float(ref.max()):.3f}): "
          f"f32 abs err max {f32_err.max():.3e} to the f32 module forward, "
          f"within rtol = atol {TOL_FORWARD:.0e}: {f32_ok}; bf16 abs err max "
          f"{bf16.max():.3e}, mean {bf16.mean():.3e} (tolerance max "
          f"{TOL_FLOW_SERVING[0]:.1e}, mean {TOL_FLOW_SERVING[1]:.1e}); bf16 "
          f"{len(many)} frames in {ms:.2f} ms ({clock}), {fps:.1f} frames/s; launches "
          f"{counts} [{smi}]")
    if not (f32_ok and bf16_ok):
        raise AssertionError("flow serving beyond its tolerances")
    return {"counts": counts, "max_abs_err": float(bf16.max()),
            "mean_abs_err": float(bf16.mean()), "frames_per_s": fps}

# ---- data parallelism, the sharded predictor, the C++ loader, the summaries and
# the profiler hook, the TF1 importer

# data parallelism at world size 1 on the card: config 2 at the CLI's defaults (C2_*),
# 5 bf16 steps; the smoothness group 1 + 1 a step as in the single-process step
DP_STEPS = 5
# the dry run at world size 1: 3 pairwise steps (phase 1's, phase 3's resumed step and
# the live step it is held to; one sig group 1 + 1 each, and the loss's 4 warps as
# plain samplings: the weights keep JAX's default "xla") and 1 distill step (the
# teacher's fused tail once)
DRYRUN_PAIRWISE_STEPS, DRYRUN_DISTILL_STEPS, DRYRUN_PLAIN_PER_STEP = 3, 1, 4
# the f32 DP step at world size 1 against the single-process step from one init: the
# synced batch norm sums and divides where the plain one takes a mean (the same sums),
# and the all-reduces over one rank leave the values as they are
TOL_DP_LOSS = 1e-6
# the same two steps computed in float64 (the heads, so the loss and its kernels, stay
# float32): Adam's first moments, (1 - beta1) times the gradients, within this share of
# each parameter's largest (``parallel/dp.py:moment_gap``). The parameters cannot hold
# the gradients (Adam's first update moves each by about lr whatever it is), and float32
# moments cannot be held either: train-mode batch norm over few values in the deepest
# layers turns float32 rounding into gradients that differ by percents (JAX's own float32
# and float64 steps too; tests/test_torch_parallel.py shows it at 32x64).
TOL_DP_MOMENTS = 1e-5
# the summaries' runs: 5 steps at each CLI's defaults, image summaries every 2
SUMMARY_STEPS, SUMMARY_FREQ = 5, 2
# the config-2 trace of run_training(profile_dir=...): steps [1, 3) of 4
PROFILE_STEPS, PROFILE_RANGE = 4, (1, 3)


def _device_kernels(prof, *needles) -> list:
    """Names of the device kernels of a profiler session whose name holds one of
    ``needles`` (lower case); the user annotations the profiler mirrors onto the device
    ("nccl:all_reduce") are not kernels."""
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and ":" not in e.name
            and any(n in e.name.lower() for n in needles)]


def _c2_batch(rng, batch: int, height: int, width: int, device) -> dict:
    """A seeded config-2 batch on ``device``: images in [0, 1), labels in [1, 2)."""
    return {"tgt_image": torch.from_numpy(
                rng.rand(batch, height, width, 3).astype(np.float32)).to(device),
            "label": torch.from_numpy(
                rng.uniform(1, 2, (batch, height, width, 1)).astype(np.float32)).to(device)}


@contextlib.contextmanager
def kernel_calls(record: dict):
    """Within the block each sig group call of the loss pipelines keeps a copy of its
    arguments in ``record["sig"]``, and each fused tail call of the folded forward its
    arguments and output in ``record["fused_tail"]``: the inputs a main path gave those
    kernels, to hold each against its plain version after the run."""
    saved_sig, saved_tail = pipelines.sig_l2_fused_group, infer_fast.fused_tail
    copy = lambda t: t.detach().clone()

    def sig(preds, gts, deltas, coefs, *eps):
        record.setdefault("sig", []).append(
            ([copy(p) for p in preds], [copy(g) for g in gts], deltas, coefs, eps))
        return saved_sig(preds, gts, deltas, coefs, *eps)

    def tail(x2, d2, params, **kw):
        out = saved_tail(x2, d2, params, **kw)
        record.setdefault("fused_tail", []).append((copy(x2), copy(d2), params, kw,
                                                    copy(out)))
        return out

    pipelines.sig_l2_fused_group, infer_fast.fused_tail = sig, tail
    try:
        yield
    finally:
        pipelines.sig_l2_fused_group, infer_fast.fused_tail = saved_sig, saved_tail


def hold_recorded_calls(record: dict, smi: str = "") -> dict:
    """Each recorded sig group call against ``sig_l2_plain_group`` on its own inputs
    (total and terms within ``TOL_SIG_FWD``, d pred and d gt of each pair within
    ``TOL_SIG_BWD`` of its |g| max, as phase 11 holds them) and each recorded fused tail
    output against ``fused_tail_reference`` (``TOL_TAIL`` of its dtype); raises beyond."""
    worst = {"sig_fwd": 0.0, "sig_bwd": 0.0, "fused_tail": 0.0}
    for preds, gts, deltas, coefs, eps in record.get("sig", []):
        runs = []
        for fn in (sig_l2_fused_group, sig_l2_plain_group):
            ps = [p.clone().requires_grad_(True) for p in preds]
            gs = [g.clone().requires_grad_(True) for g in gts]
            total, per_map = fn(ps, gs, deltas, coefs, *eps)
            runs.append((total.detach(), per_map.detach(),
                         torch.autograd.grad(total, ps + gs)))
        (total, terms, grads), (r_total, r_terms, r_grads) = runs
        fwd = max(_rel(total.item(), r_total.item()), _each_rel(terms, r_terms))
        bwd = max(_max_rel(g, r) for g, r in zip(grads, r_grads))
        print(f"kernel sig_l2 group on the dry run's inputs ({len(preds)} pairs, "
              f"{[tuple(p.shape) for p in preds]}, deltas {list(deltas)}): total and terms "
              f"rel err {fwd:.3e} vs plain (rtol {TOL_SIG_FWD:.0e}); gradients within "
              f"{bwd:.3e} x their |g| max (tolerance {TOL_SIG_BWD:.0e}) [{smi}]")
        if fwd > TOL_SIG_FWD or bwd > TOL_SIG_BWD:
            raise AssertionError("sig group on the dry run's inputs: beyond its tolerances")
        worst["sig_fwd"] = max(worst["sig_fwd"], fwd)
        worst["sig_bwd"] = max(worst["sig_bwd"], bwd)
    for x2, d2, params, kw, out in record.get("fused_tail", []):
        ref = fused_tail_reference(x2, d2, params, **kw)
        err, mean = (out - ref).abs().max().item(), (out - ref).abs().mean().item()
        tol_max, tol_mean = TOL_TAIL[x2.dtype]
        print(f"kernel fused_tail {str(x2.dtype)[6:]} on the dry run's inputs "
              f"{tuple(x2.shape)}: abs err max {err:.3e}, mean {mean:.3e} vs "
              f"fused_tail_reference, tolerance max {tol_max:.0e}, mean {tol_mean:.0e} "
              f"[{smi}]")
        if not bool(torch.isfinite(out).all()) or err > tol_max or mean > tol_mean:
            raise AssertionError("fused_tail on the dry run's inputs: beyond its tolerances")
        worst["fused_tail"] = max(worst["fused_tail"], err)
    return worst


def _c2_state(device, dtype: torch.dtype):
    model = DispNet(DispNetVariant.depth4(), generator=torch.Generator().manual_seed(SEED),
                    dtype=dtype).to(device)
    return create_train_state(model)


def phase_dp(device, root: str, *, height: int = C2_HEIGHT, width: int = C2_WIDTH,
             batch: int = C2_BATCH, steps: int = DP_STEPS, smi: str = "") -> dict:
    """Data parallelism on one device: the default process group at world size 1 (NCCL on
    the card, gloo on the CPU) through a ``FileStore`` under ``root``. Then, three main
    paths, each between count resets: ``steps`` bf16 data-parallel config-2 steps (the
    counts read after each step: 1 + 1 smoothness launches; under the profiler, NCCL's
    all-reduce kernels counted a step); one f32 data-parallel step against the
    single-process step from one init and batch (loss rel ``TOL_DP_LOSS``, params within
    2 lr) and the same pair computed in float64 (Adam's first moments within
    ``TOL_DP_MOMENTS``); and the dry run's three phases (``parallel/dryrun.py:run_phases``),
    whose sig group and fused tail calls are then held against their plain versions on
    the inputs the run gave them."""
    cuda = torch.device(device).type == "cuda"
    store = os.path.join(root, "group")
    os.makedirs(store, exist_ok=True)
    group = init_process_group(store, 0, 1, "nccl" if cuda else "gloo")
    try:
        w = dataclasses.replace(LossWeights.depth_only(), height=height, width=width)
        rng = np.random.RandomState(SEED + 40)
        state = _c2_state(device, torch.bfloat16)
        dp_step = make_dp_step(make_depth_only_step(w), group)
        per_step, totals = [], []
        activities = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(steps):
                b = _c2_batch(rng, batch, height, width, device)
                reset_counts()
                state, metrics = dp_step(state, b)
                per_step.append(read_counts())
                totals.append(float(metrics["total"]))
        seconds = time.perf_counter() - t0
        nccl = _device_kernels(prof, "nccl", "onerank")
        if not all(np.isfinite(totals)) or state.step != steps:
            raise AssertionError(f"DP config 2: step {state.step}, totals {totals}")
        _check_per_step("DP config 2", per_step,
                        {"smoothness_fwd": 1, "smoothness_bwd": 1} if cuda else {})
        if cuda and len(nccl) < steps:
            raise AssertionError(f"DP config 2: {len(nccl)} NCCL kernels in {steps} steps")
        print(f"DP config 2: {steps} bf16 steps ({height}x{width}, global batch {batch}, "
              f"world size 1, {dist.get_backend(group)}) in {seconds:.2f} s host clock "
              f"(profiled), totals {', '.join(f'{t:.4f}' for t in totals)}; smoothness 1 + 1 "
              f"a step; NCCL kernels {len(nccl)} ({sorted(set(nccl))[:2]}) [{smi}]")

        b = _c2_batch(rng, batch, height, width, device)
        runs = {}
        for dt in (torch.float32, torch.float64):
            for way, step in (("dp", dp_step), ("single", make_depth_only_step(w))):
                runs[dt, way] = step(_c2_state(device, dt), b)
        (dp32, m_dp), (single32, m_single) = runs[torch.float32, "dp"], runs[torch.float32,
                                                                              "single"]
        rel = _rel(float(m_dp["total"]), float(m_single["total"]))
        worst = max((p - q).abs().max().item() for p, q in zip(dp32.model.parameters(),
                                                              single32.model.parameters()))
        lr = dp32.optimizer.param_groups[0]["lr"]
        gap32 = moment_gap(dp32, single32)
        gap = moment_gap(runs[torch.float64, "dp"][0], runs[torch.float64, "single"][0])
        del runs, dp32, single32
        print(f"DP config 2 f32 step vs the single-process step: loss "
              f"{float(m_dp['total']):.6f} vs {float(m_single['total']):.6f} (rel {rel:.2e}, "
              f"limit {TOL_DP_LOSS:.0e}), "
              f"params {worst:.3e} apart at most (limit 2 lr = {2 * lr:.1e}), first moments "
              f"{gap32:.3e} of their largest apart (not held in float32); in float64 the "
              f"first moments {gap:.3e} apart (limit {TOL_DP_MOMENTS:.0e}) [{smi}]")
        if rel > TOL_DP_LOSS or worst > 2 * lr * (1 + 1e-4) or gap > TOL_DP_MOMENTS:
            raise AssertionError("the DP step differs from the single-process step")

        reset_counts()  # a main path: the dry run
        t0 = time.perf_counter()
        record = {}
        with kernel_calls(record):
            dry = dryrun.run_phases(group, device, os.path.join(root, "dryrun"))
        dry_counts = read_counts()
        want = {k: 0 for k in dry_counts}
        want["plain_samples"] = DRYRUN_PLAIN_PER_STEP * DRYRUN_PAIRWISE_STEPS
        if cuda:
            want.update(sig_fwd=DRYRUN_PAIRWISE_STEPS, sig_bwd=DRYRUN_PAIRWISE_STEPS,
                        fused_tail=DRYRUN_DISTILL_STEPS)
        print(f"dryrun_multichip at world size 1: {dry} in {time.perf_counter() - t0:.2f} s; "
              f"launches {dry_counts} [{smi}]")
        if dry_counts != want:
            raise AssertionError(f"the dry run launched {dry_counts}, not {want}")
        calls = {k: len(v) for k, v in record.items()}
        if calls != {"sig": DRYRUN_PAIRWISE_STEPS, "fused_tail": DRYRUN_DISTILL_STEPS}:
            raise AssertionError(f"the dry run called the wrappers {calls} times")
        dry_errs = hold_recorded_calls(record, smi)
    finally:
        dist.destroy_process_group()
    return {"per_step": per_step, "nccl_kernels": len(nccl), "loss_rel": rel,
            "param_diff": worst, "moment_gap": gap, "moment_gap_f32": gap32, "dryrun": dry,
            "dryrun_counts": dry_counts, "dryrun_errs": dry_errs}


def phase_sharded_predictor(variables: dict, device, height: int = HEIGHT,
                            width: int = WIDTH, batch: int = 8, smi: str = "") -> dict:
    """``DepthPredictor(num_devices=1)`` answers 12 frames (a batch and a padded tail) as
    the default predictor does, bit for bit, and ``num_devices`` above the machine's
    device count raises."""
    frames = _frames(12, height, width, seed=SEED + 41)
    kw = dict(height=height, width=width, batch_size=batch, device=device)
    got = DepthPredictor(variables["params"], variables["batch_stats"], num_devices=1,
                         **kw).predict_array(frames)
    want = DepthPredictor(variables["params"], variables["batch_stats"],
                          **kw).predict_array(frames)
    if not np.array_equal(got, want):
        raise AssertionError("DepthPredictor(num_devices=1) differs from the default")
    n = torch.cuda.device_count() + 1
    try:
        DepthPredictor(variables["params"], variables["batch_stats"], height=height,
                       width=width, batch_size=batch, device="cuda", num_devices=n)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"DepthPredictor(num_devices={n}) did not raise")
    print(f"sharded predictor: num_devices=1 answers {len(frames)} frames as the default "
          f"(bit-equal); num_devices={n} raises: {refused} [{smi}]")
    return {"refused": refused}


def phase_native_loader(device, dataset: str, *, height: int = C2_HEIGHT,
                        width: int = C2_WIDTH, batch: int = C2_BATCH,
                        steps: int = DP_STEPS, dtype: str = "bfloat16",
                        smi: str = "") -> dict:
    """The C++ loader built from ``native/fastloader.cc`` with g++ (its seconds printed),
    its samples (one thread, in order) within ``tests/test_torch_native_loader.py``'s
    limits of the NumPy dataset, then a main path: ``depth_only --native_loader`` for
    ``steps`` steps, the counts set to 0 before and read after (1 + 1 smoothness a
    step)."""
    built = native.build()
    print(f"native loader: built {os.path.relpath(built['path'], ROOT)} with g++ in "
          f"{built['seconds']:.2f} s wall (0: cached)")
    ds = PairDepthDataset(dataset, split="train", image_height=height, image_width=width,
                          resized_height=height, resized_width=width)
    samples = list(native.NativePairSampler(ds, num_threads=1, shuffle=False))
    if len(samples) != len(ds):
        raise AssertionError(f"native loader: {len(samples)} of {len(ds)} samples")
    worst = {"image": 0.0, "label": 0.0, "intrinsics": 0.0}
    for i, s in enumerate(samples):
        ref = ds[i]
        worst["image"] = max(worst["image"], *(float(np.abs(s[k] - ref[k]).max())
                                               for k in ("tgt_image", "src_image")))
        worst["label"] = max(worst["label"], float(np.abs(s["label"] - ref["label"]).max()))
        worst["intrinsics"] = max(worst["intrinsics"], float(np.abs(
            s["intrinsics"] - ref["intrinsics"]).max() / np.abs(ref["intrinsics"]).max()))
    print(f"native loader: {len(samples)} samples at {height}x{width} vs the NumPy dataset: "
          f"image abs err max {worst['image']:.3f} (limit 2.5), label {worst['label']:.2e} "
          f"(1e-5), intrinsics rel {worst['intrinsics']:.1e} (1e-6)")
    if worst["image"] > 2.5 or worst["label"] > 1e-5 or worst["intrinsics"] > 1e-6:
        raise AssertionError("native loader samples beyond the NumPy dataset's limits")
    ckpt = os.path.join(os.path.dirname(dataset), "checkpoints_native")
    reset_counts()  # a main path: depth_only --native_loader
    t0 = time.perf_counter()
    state, last = depth_only.main([
        "--dataset_dir", dataset, "--checkpoint_dir", ckpt, "--batch_size", str(batch),
        "--max_steps", str(steps), "--summary_freq", "1", "--save_latest_freq", str(steps),
        "--validation_check", "0", "--image_height", str(height), "--image_width",
        str(width), "--dtype", dtype, "--device", str(device), "--seed", str(SEED),
        "--native_loader"])
    counts = read_counts()
    seconds = time.perf_counter() - t0
    want = {k: 0 for k in counts}
    if torch.device(device).type == "cuda":
        want.update(smoothness_fwd=steps, smoothness_bwd=steps)
    _records(ckpt, ("total", "depth", "smooth"))
    print(f"depth_only --native_loader: {state.step} {dtype} steps ({height}x{width}, batch "
          f"{batch}) in {seconds:.1f} s host clock, last total {last['total']:.4f}; "
          f"launches {counts} [{smi}]")
    if state.step != steps or counts != want:
        raise AssertionError(f"depth_only --native_loader: step {state.step}, launches "
                             f"{counts}, not {want}")
    return {"build_seconds": built["seconds"], "counts": counts, **worst}


def _event_tags(directory: str):
    """{"scalars", "images", "histograms"} tags of the event files under ``directory``,
    read by tensorboard's own reader (no TensorFlow needed)."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(directory)
    acc.Reload()
    tags = acc.Tags()
    return {k: set(tags.get(k, ())) for k in ("scalars", "images", "histograms")}


def _split_summary_tags(comps) -> dict:
    per_scale = ("left_image", "right_image", "pred_depth_left", "pred_depth_right",
                 "projected_image_left", "project_error_left")
    return {"scalars": {f"train/{k}" for k in (*comps, "steps_per_sec", "frames_per_sec")},
            "images": {f"scale{s}_{n}" for s in range(2) for n in per_scale}
            | {"val_depth", "val_depth_inv", "val_image"},
            "histograms": {"scale0_pred_depth_single_left", "scale0_pred_depth_single_right",
                           "image_value_range", "scale_depth"}}


def _depth_summary_tags(comps) -> dict:
    return {"scalars": {f"train/{k}" for k in (*comps, "steps_per_sec", "frames_per_sec")},
            "images": {"target_image"} | {f"scale{s}_pred_depth" for s in range(4)},
            "histograms": {"image_value_range", "scale0_pred_depth", "scale_depth"}}


def phase_summaries(device, root: str, dataset: str, *, steps: int = SUMMARY_STEPS,
                    freq: int = SUMMARY_FREQ, st_hw=(ST_HEIGHT, ST_WIDTH),
                    st_batch: int = ST_BATCH, c2_hw=(C2_HEIGHT, C2_WIDTH),
                    c2_batch: int = C2_BATCH, dtype: str = "bfloat16",
                    smi: str = "") -> dict:
    """Two main paths, each between count resets: split_training's phase 1 with
    ``--rich_summaries --tensorboard`` (``train_pair``, synthetic DeMoN batches; sig 1 + 1
    a step) and ``depth_only --rich_summaries`` (smoothness 1 + 1 a step), ``steps``
    steps each at the CLIs' defaults with ``--image_summary_freq freq``: where the
    tensorboard package is installed, event files with the JAX package's scalar, image and
    histogram tags, the images at the summary steps; where it is not, the "tensorboard
    writer unavailable" line. Then the profiler hook: ``run_training(profile_dir=...)`` on
    config 2 records steps ``PROFILE_RANGE`` as one trace, which on the card names the
    smoothness kernels."""
    import importlib.util
    import io

    cuda = torch.device(device).type == "cuda"
    has_tb = importlib.util.find_spec("tensorboard") is not None
    common = ["--summary_freq", "1", "--save_latest_freq", str(steps), "--dtype", dtype,
              "--device", str(device), "--seed", str(SEED), "--max_steps", str(steps),
              "--image_summary_freq", str(freq)]
    out, logs = {}, {}
    split_dir = os.path.join(root, "split_summaries")
    args = split_training.parse_args(common + [
        "--checkpoint_dir", split_dir, "--image_height", str(st_hw[0]), "--image_width",
        str(st_hw[1]), "--batch_size", str(st_batch), "--rich_summaries", "--tensorboard"])
    w = split_training.loss_weights(args)
    log = io.StringIO()
    reset_counts()  # a main path: split_training phase 1 with the summaries
    with contextlib.redirect_stdout(log):
        split_training.train_pair(args, w, split_training.pair_state(args),
                                  demon_batches(st_batch, *st_hw, device))
    out["split"] = read_counts()
    logs["split"] = log.getvalue()
    c2_dir = os.path.join(root, "depth_only_summaries")
    log = io.StringIO()
    reset_counts()  # a main path: depth_only with the summaries
    with contextlib.redirect_stdout(log):
        depth_only.main(common + ["--dataset_dir", dataset, "--checkpoint_dir", c2_dir,
                                  "--image_height", str(c2_hw[0]), "--image_width",
                                  str(c2_hw[1]), "--batch_size", str(c2_batch),
                                  "--validation_check", "0", "--rich_summaries"])
    out["depth_only"] = read_counts()
    logs["depth_only"] = log.getvalue()
    kernel = {"split": ("sig_fwd", "sig_bwd"), "depth_only": ("smoothness_fwd",
                                                               "smoothness_bwd")}
    expected = {"split": _split_summary_tags(("total", "depth", "cam", "consist", "sig",
                                              "exp", "pixel")),
                "depth_only": _depth_summary_tags(("total", "depth", "smooth"))}
    for name, directory in (("split", split_dir), ("depth_only", c2_dir)):
        # the pairwise loss's and summary's warps keep JAX's "xla": plain samplings
        want = {k: 0 for k in out[name] if k != "plain_samples"}
        if cuda:
            want.update({k: steps for k in kernel[name]})
        if {k: out[name][k] for k in want} != want:
            raise AssertionError(f"{name} with summaries launched {out[name]}, not {want}")
        if has_tb:
            tags = _event_tags(os.path.join(directory, "sum"))
            missing = {k: expected[name][k] - tags[k] for k in tags}
            if any(missing.values()) or tags["images"] != expected[name]["images"]:
                raise AssertionError(f"{name}: event tags {tags}, missing {missing}")
            print(f"{name} --rich_summaries: {steps} steps, launches {out[name]}; event "
                  f"files with {len(tags['scalars'])} scalar, {len(tags['images'])} image "
                  f"and {len(tags['histograms'])} histogram tags (JAX's) [{smi}]")
        else:
            if "tensorboard writer unavailable" not in logs[name]:
                raise AssertionError(f"{name}: no tensorboard and no 'unavailable' line")
            print(f"{name} --rich_summaries: {steps} steps, launches {out[name]}; no "
                  f"tensorboard package: 'tensorboard writer unavailable', no event files "
                  f"[{smi}]")
    out["tensorboard"] = has_tb

    w = dataclasses.replace(LossWeights.depth_only(), height=c2_hw[0], width=c2_hw[1])
    rng = np.random.RandomState(SEED + 42)
    batches = iter([_c2_batch(rng, c2_batch, *c2_hw, device) for _ in range(PROFILE_STEPS)])
    prof_dir = os.path.join(root, "profile")
    logger = MetricLogger(os.path.join(root, "profile_log"), quiet=True)
    run_training(state=_c2_state(device, torch.bfloat16), train_step=make_depth_only_step(w),
                 batches=batches, max_steps=PROFILE_STEPS, logger=logger, summary_freq=0,
                 profile_dir=prof_dir, profile_steps=PROFILE_RANGE)
    logger.close()
    traces = sorted(os.listdir(prof_dir))
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    smooth = [n for n in kernels if "smooth" in n.lower()]
    print(f"run_training(profile_dir=...): {traces}, {len(events)} events, {len(kernels)} "
          f"kernels, of them {len(smooth)} smoothness ({sorted(set(smooth))}) [{smi}]")
    n_steps = PROFILE_RANGE[1] - PROFILE_RANGE[0]
    if len(traces) != 1 or (cuda and len(smooth) < 2 * n_steps):
        raise AssertionError(f"profile trace {traces}: {len(smooth)} smoothness kernels in "
                             f"{n_steps} steps")
    out["trace_kernels"], out["trace_smoothness"] = len(kernels), len(smooth)
    return out


def phase_tf1_import(device, height: int = HEIGHT, width: int = WIDTH, batch: int = 8,
                     smi: str = "") -> dict:
    """Seeded arrays under the reference's slim names (``depth_net/...``, He-scaled
    kernels, positive variances) through ``import_tf1_variables`` into depth4 DispNet's
    tree, served by a bf16 ``DepthPredictor`` (the folded forward; one ``fused_tail``
    launch for a batch) on ``batch`` frames, a main path between count resets; the
    answer bit-equal to serving the seeded tree directly."""
    rng = np.random.RandomState(SEED + 43)
    direct = []
    for path, leaf in tf1_import._leaves(tf1_import.init_variables("dispnet")):
        shape = np.shape(leaf)
        value = rng.randn(*shape).astype(np.float32)
        if path[-1] == "var":
            value = np.abs(value) + 0.1
        elif path[-1] == "kernel":
            value *= np.sqrt(2.0 / np.prod(shape[:-1]))
        direct.append((path, value))
    tf1_vars = {tf1_import.tf1_name_for(p, "dispnet", "depth_net"): v for p, v in direct}
    tree, paths = tf1_import.import_tf1_variables(
        tf1_vars, tf1_import.init_variables("dispnet"), "dispnet", "depth_net")
    direct = tf1_import._unflatten(direct)
    frames = _frames(batch, height, width, seed=SEED + 44)
    kw = dict(height=height, width=width, batch_size=batch, device=device)
    reset_counts()  # a main path: serving the imported weights
    got = DepthPredictor(tree["params"], tree["batch_stats"], **kw).predict_array(frames)
    counts = read_counts()
    want = DepthPredictor(direct["params"], direct["batch_stats"], **kw).predict_array(frames)
    expect = {k: 0 for k in counts}
    if torch.device(device).type == "cuda":
        expect["fused_tail"] = 1
    print(f"TF1 import: {len(tf1_vars)} slim variables -> {len(paths)} leaves of depth4 "
          f"DispNet; served {batch} frames at {height}x{width} (bf16, folded): "
          f"{'bit-equal' if np.array_equal(got, want) else 'DIFFERENT'} to serving the "
          f"seeded tree directly, finite {bool(np.isfinite(got).all())}; launches {counts} "
          f"[{smi}]")
    if not np.array_equal(got, want) or not np.isfinite(got).all() or counts != expect:
        raise AssertionError(f"TF1-imported serving: launches {counts}, not {expect}, or "
                             f"not the direct answer")
    return {"counts": counts, "leaves": len(paths)}


def reset_counts() -> None:
    fused_tail.launches = bilinear_sample.launches = bilinear_sample.backward_launches = 0
    smoothness_fused.launches = smoothness_fused.backward_launches = 0
    sig_l2_fused.launches = sig_l2_fused.backward_launches = 0
    bilinear_sample_fused.launches = bilinear_sample_fused.backward_launches = 0
    dot_loop.launches = dot_grid.launches = 0
    dot_loop.transposes = dot_grid.transposes = dot_loop.reduces = 0
    bilinear_sample_reference.calls = 0


def read_counts(sync: bool = True) -> dict:
    """The kernels' launch counts, and the plain sampler's calls (``plain_samples``)."""
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"fused_tail": fused_tail.launches, "bilinear_sample": bilinear_sample.launches,
            "bilinear_sample_bwd": bilinear_sample.backward_launches,
            "smoothness_fwd": smoothness_fused.launches,
            "smoothness_bwd": smoothness_fused.backward_launches,
            "sig_fwd": sig_l2_fused.launches, "sig_bwd": sig_l2_fused.backward_launches,
            "fused_fwd": bilinear_sample_fused.launches,
            "fused_bwd": bilinear_sample_fused.backward_launches,
            "dot_loop": dot_loop.launches, "dot_grid": dot_grid.launches,
            "dot_loop_transposes": dot_loop.transposes,
            "dot_grid_transposes": dot_grid.transposes, "dot_loop_reduces": dot_loop.reduces,
            "plain_samples": bilinear_sample_reference.calls}


def main() -> None:
    t_start = time.perf_counter()

    def stamp(label: str) -> None:
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s after {label}")

    info = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    stamp("build")
    variables, meta = load_variables_npz(TEACHER)
    print(f"weights: {os.path.relpath(TEACHER, ROOT)} {meta}")
    folded = {dt: fold_weights(variables, dtype=dt, device="cuda")
              for dt in (torch.float32, torch.bfloat16)}
    errs = phase_kernel(folded)
    fwd = phase_forward(variables, "cuda")
    if fwd["launches"] < 1:
        raise AssertionError("the f32 forward did not launch fused_tail")

    reset_counts()  # a main path: serving
    phase_serving(variables, "cuda")
    serving = read_counts()
    print(f"serving launches: {serving}")
    if serving["fused_tail"] < 1:
        raise AssertionError("serving did not launch fused_tail")
    stamp("serving")

    rows = phase_times(folded, info["smi"])
    stamp("serving times")
    main_row = rows[(8, torch.bfloat16)]  # the serving path's shapes and dtype
    sample_errs = phase_sampler("cuda", info["smi"])
    smooth_errs = phase_smoothness("cuda", info["smi"])
    sig_errs = phase_sig("cuda", info["smi"])
    stamp("kernel checks")

    with tempfile.TemporaryDirectory() as tmp:
        dataset = write_dataset(tmp)
        reset_counts()  # a main path: config-4 training
        phase_training("cuda", dataset, smi=info["smi"])
        training = read_counts()
        print(f"training launches: {training} in {C4_STEPS} steps [{info['smi']}]")
        n_fwd, n_bwd = SMOOTH_PER_STEP["optflow_combine"]
        want = {"bilinear_sample": SAMPLER_PER_STEP[0] * C4_STEPS,
                "bilinear_sample_bwd": SAMPLER_PER_STEP[1] * C4_STEPS,
                "fused_fwd": 0, "fused_bwd": 0, "plain_samples": 0,
                "smoothness_fwd": n_fwd * C4_STEPS, "smoothness_bwd": n_bwd * C4_STEPS}
        if {k: training[k] for k in want} != want:
            raise AssertionError(f"config-4 training launched {training} in {C4_STEPS} "
                                 f"steps, not {want}")
        batch = first_batch(dataset, "cuda")
        stamp("config-4 training")

        reset_counts()  # a main path: config-2 training with validation
        c2 = phase_depth_only("cuda", dataset, smi=info["smi"])
        depth_counts = read_counts()
        print(f"depth_only launches: {depth_counts} in {C2_STEPS} steps and "
              f"{c2['validations']} validations [{info['smi']}]")
        n_fwd, n_bwd = SMOOTH_PER_STEP["depth_only"]
        want = (n_fwd * C2_STEPS + SMOOTH_PER_VAL * c2["validations"], n_bwd * C2_STEPS)
        if (depth_counts["smoothness_fwd"], depth_counts["smoothness_bwd"]) != want:
            raise AssertionError(f"config-2 training launched smoothness {depth_counts}, "
                                 f"not {want} (forward, backward)")
        # a main path: config 2's checkpoint served from its directory, counts inside
        c2_served = phase_depth_checkpoint_serving("cuda", c2["checkpoint"], smi=info["smi"])
        want = {k: 0 for k in c2_served["counts"]}
        want["fused_tail"] = c2_served["batches"]
        if c2_served["counts"] != want:
            raise AssertionError(f"depth serving from a checkpoint launched "
                                 f"{c2_served['counts']}, not {want}")
        stamp("config-2 training and checkpoint serving")

        # a main path: depth_only --turbo colon, counts inside
        c2t = phase_depth_only_turbo("cuda", dataset, smi=info["smi"])
        want = {k: 0 for k in c2t["counts"]}
        want["smoothness_fwd"] = n_fwd * C2_STEPS + SMOOTH_PER_VAL * c2t["validations"]
        want["smoothness_bwd"] = n_bwd * C2_STEPS
        if c2t["counts"] != want:
            raise AssertionError(f"depth_only --turbo launched {c2t['counts']}, not {want}")
        stamp("depth_only --turbo training and serving")

        # two main paths: split_training's phases, each between its own count resets
        split = phase_split_training("cuda", os.path.join(tmp, "split"), smi=info["smi"])
        for phase, (n_fwd, n_bwd) in SIG_PER_STEP.items():
            got = split[phase]
            print(f"split_training {phase} launches: {got} in {ST_STEPS} steps "
                  f"[{info['smi']}]")
            if (got["sig_fwd"], got["sig_bwd"]) != (n_fwd * ST_STEPS, n_bwd * ST_STEPS):
                raise AssertionError(f"split_training {phase} launched sig {got}, not "
                                     f"{n_fwd} + {n_bwd} a step")
        stamp("split_training")

        fused_errs = phase_fused_sampler("cuda", info["smi"])
        reset_counts()  # a main path: config-3 training
        c3 = phase_depth_then_cam("cuda", tmp, smi=info["smi"])
        c3_counts = read_counts()
        for i, n in enumerate(c3["per_step"], start=1):
            if {k: n[k] for k in C3_PER_STEP} != C3_PER_STEP:
                raise AssertionError(f"config-3 step {i} launched {n}, not {C3_PER_STEP}")
        print(f"depth_then_cam launches: {c3_counts} in {C3_STEPS} steps, "
              f"{C3_PER_STEP} a step [{info['smi']}]")
        stamp("fused sampler checks and config-3 training")
        # two main paths: the eval harness's nets, each between its own count resets
        evals = phase_eval_harness("cuda", tmp, c3["variables"], smi=info["smi"])
        for net, (_, counts) in evals.items():
            want = (SIG_PER_EVAL_BATCH[net] * EVAL_BATCHES, 0)
            if (counts["sig_fwd"], counts["sig_bwd"]) != want:
                raise AssertionError(f"eval harness --net {net} launched sig {counts}, "
                                     f"not {want}")
        # two main paths: pair serving of the full-resolution net (config 3's checkpoint)
        # and of the truncated one (split_training's phase 1, the net the CLI serves)
        for net, pv in (("full-resolution", c3["variables"]),
                        ("truncated", split["pair_variables"])):
            reset_counts()
            phase_pair_serving("cuda", pv, smi=info["smi"])
            pair_counts = read_counts()
            print(f"pair serving {net} launches: {pair_counts} [{info['smi']}]")
        stamp("eval harness and pair serving")
    phase_step_parity("cuda", batch, info["smi"])
    stamp("config-4 step parity")
    srow = phase_sampler_times("cuda", info["smi"])
    phase_training_times("cuda", batch, info["smi"])
    stamp("config-4 times")
    mrow = phase_smooth_times("cuda", info["smi"], srow["profile"])["optflow_combine"]
    phase_depth_only_times("cuda", info["smi"])
    stamp("smoothness and config-2 times")
    phase_split_parity("cuda", info["smi"])
    stamp("split_training step parity")
    sig_row = phase_sig_times("cuda", info["smi"])["phase-2 step, 4 pairs"]
    split_rows = phase_split_times("cuda", info["smi"])
    stamp("sig and split_training times")
    phase_depth_then_cam_parity("cuda", info["smi"])
    frow = phase_fused_times("cuda", info["smi"])
    frow["device_ms"] = phase_depth_then_cam_times("cuda", info["smi"])["kernel"]["sampler_ms"]
    stamp("config-3 step parity and times")

    phase_sass()
    probe_errs = phase_probes("cuda")
    reset_counts()  # two main paths: the probes' own entry points
    phase_probe_tools()
    probe_counts = read_counts()
    print(f"probe tools launches: {probe_counts} [{info['smi']}]")
    for name in PROBE_SHAPES:
        got = (probe_counts[name], probe_counts[f"{name}_transposes"],
               probe_counts.get(f"{name}_reduces", 0))
        want = (PROBE_TOOL_LAUNCHES, PROBE_TOOL_TRANSPOSES, PROBE_TOOL_REDUCES[name])
        if got != want:
            raise AssertionError(f"the {name} probe launched (products, transposes, "
                                 f"reduces) {got}, not {want}")
    prow = phase_probe_times("cuda", info["smi"])
    stamp("probe checks and times")
    phase_turbo_parity("cuda")
    reset_counts()  # a main path: turbo serving
    phase_turbo_serving("cuda", info["smi"])
    turbo_counts = read_counts()
    print(f"turbo serving launches: {turbo_counts} (no kernel of this package on this "
          f"path) [{info['smi']}]")
    if any(turbo_counts.values()):
        raise AssertionError(f"turbo serving launched {turbo_counts}")
    stamp("turbo parity and serving")

    with tempfile.TemporaryDirectory() as tmp:
        dist = phase_distill("cuda", tmp, smi=info["smi"])  # a main path, counts inside
    want = {k: 0 for k in dist["counts"]}
    want["fused_tail"] = (TAIL_PER_DISTILL_STEP * DISTILL_STEPS
                          + TAIL_PER_DISTILL_VAL * dist["validations"])
    if dist["counts"] != want:
        raise AssertionError(f"distillation launched {dist['counts']}, not {want}")
    stamp("distillation")
    phase_distill_parity("cuda", info["smi"])
    dtimes = phase_distill_times("cuda", info["smi"])
    stamp("distillation parity and times")
    reset_counts()  # a main path: depth serving through the module forward
    phase_serving(variables, "cuda", use_fast=False)
    module_counts = read_counts()
    if any(module_counts.values()):
        raise AssertionError(f"module-forward serving launched {module_counts}")
    phase_device_cache("cuda", info["smi"])
    stamp("module serving and DeviceCache")

    lr_sample_errs = phase_lr_sampler("cuda", info["smi"])
    demon = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()  # a main path: config-5 training
        c5 = phase_on_demon("cuda", tmp, smi=info["smi"])
        demon["on_demon"] = read_counts()
        _check_per_step("config 5", c5["per_step"], DEMON_PER_STEP["on_demon"])
        reset_counts()  # a main path: config 5's checkpoint served by PairPredictor
        phase_pair_serving("cuda", c5["variables"], smi=info["smi"])
        c5_served = read_counts()
        if any(c5_served.values()):
            raise AssertionError(f"pair serving of config 5's checkpoint launched {c5_served}")
        for mode in LR_MODES:
            reset_counts()  # a main path: the L/R family in one mode
            lr = phase_lr("cuda", tmp, mode, smi=info["smi"])
            demon[mode] = read_counts()
            _check_per_step(mode, lr["per_step"], DEMON_PER_STEP[mode])
    for config, counts in demon.items():
        print(f"{config} launches: {counts} in {C5_STEPS if config == 'on_demon' else LR_STEPS} "
              f"steps, {DEMON_PER_STEP[config]} a step and nothing else [{info['smi']}]")
    stamp("config 5 and the L/R family")
    phase_lr_parity("cuda", info["smi"])
    demon_times = phase_demon_times("cuda", info["smi"])
    stamp("L/R step parity and the DeMoN-stream times")

    colon, colon_counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        pairs = write_dataset(tmp)   # 240x720 JPEG pairs, 10 in the train split
        dim11_data, dim11_depth = write_dim11_dataset(tmp)
        for mode in COLON_MODES:
            reset_counts()  # a main path: a colon-pair mode through its CLI
            d11 = mode == "dim11"
            run = phase_colon("cuda", tmp, mode, dim11_data if d11 else pairs,
                              depth_dir=dim11_depth if d11 else None, smi=info["smi"])
            colon_counts[mode] = read_counts()
            _check_per_step(mode, run["per_step"], COLON_PER_STEP[mode])
            if run["groups"] != [(COLON_SMOOTH_MAPS[mode],) * 2] * OF_STEPS:
                raise AssertionError(f"{mode}: smoothness groups (maps, eligible C=1 maps) "
                                     f"{run['groups']}, not {COLON_SMOOTH_MAPS[mode]} a step")
            colon[mode] = run
        reset_counts()  # a main path: the sfm checkpoint served through the module forward
        phase_sfm_serving("cuda", colon["sfm"]["variables"], smi=info["smi"])
        sfm_served = read_counts()
        if any(sfm_served.values()):
            raise AssertionError(f"sfm serving launched {sfm_served}")
    for mode, counts in colon_counts.items():
        print(f"{mode} launches: {counts} in {OF_STEPS} steps, {COLON_PER_STEP[mode]} a "
              f"step and nothing else; smoothness groups of {COLON_SMOOTH_MAPS[mode]} C=1 "
              f"maps [{info['smi']}]")
    stamp("the colon-pair families")
    phase_colon_parity("cuda", info["smi"])
    colon_times = phase_colon_times("cuda", info["smi"])
    stamp("colon-pair step parity and times")

    with tempfile.TemporaryDirectory() as tmp:
        rf = phase_refine("cuda", tmp, smi=info["smi"])   # a main path, counts inside
    _check_per_step("refinement", rf["per_step"], refine_per_step(refine.SAMPLER))
    if rf["groups"] != [(RF_WARPS, RF_WARPS)] * RF_STEPS:
        raise AssertionError(f"refinement: smoothness groups (maps, eligible C=1 maps) "
                             f"{rf['groups']}, not {RF_WARPS} a step")
    rf_counts = {k: sum(n[k] for n in rf["per_step"]) for k in rf["per_step"][0]}
    print(f"refinement launches: {rf_counts} in {RF_STEPS} steps, "
          f"{refine_per_step(refine.SAMPLER)} a step and nothing else [{info['smi']}]")
    phase_refine_parity("cuda", info["smi"])
    rf_times = phase_refine_times("cuda", info["smi"])
    flow = phase_flow_serving("cuda", smi=info["smi"])   # a main path, counts inside
    if any(flow["counts"].values()):
        raise AssertionError(f"flow-augmented serving launched {flow['counts']}")
    stamp("refinement and flow-augmented serving")
    # ms/step of the f32 refine step on each sampler route and the median of the rounds'
    # paired differences (the preset's rule), for the kernels' rows
    rf_step_ms = {**{k: rf_times[k]["ms"] for k in ("pallas", "xla")},
                  "median_diff": rf_times["median_diff"]}

    with tempfile.TemporaryDirectory() as tmp:
        dp = phase_dp("cuda", tmp, smi=info["smi"])   # three main paths, counts inside
        phase_sharded_predictor(variables, "cuda", smi=info["smi"])
        pairs = write_dataset(tmp)   # 240x720 JPEG pairs, 10 in the train split
        if native.available():   # a main path, counts inside
            nat = phase_native_loader("cuda", pairs, smi=info["smi"])
        else:
            nat = {"counts": {"smoothness_fwd": None, "smoothness_bwd": None}}
            why = " / ".join(native.build_error().splitlines()[:3])
            print(f"native loader: left out, it cannot build here: {why}")
        summ = phase_summaries("cuda", tmp, pairs, smi=info["smi"])   # two main paths
    tf1 = phase_tf1_import("cuda", smi=info["smi"])   # a main path, counts inside
    stamp("data parallelism, the C++ loader, the summaries and the TF1 importer")

    kernels = [{
        "name": "fused_tail", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/fused_tail.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_tail.py:112",
        "launches": serving["fused_tail"], "max_abs_err": errs[torch.bfloat16],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
        # the native chain of the same layers (cuDNN, several calls): a yardstick
        "native_chain_ms": main_row["native_ms"],
        # the other main paths' launches: 5 distill steps and 2 validations (the teacher),
        # and depth serving from config 2's checkpoint directory
        "distill_launches": dist["counts"]["fused_tail"],
        "checkpoint_serving_launches": c2_served["counts"]["fused_tail"],
        "distill_step_ms": dtimes["step"], "distill_teacher_ms": dtimes["teacher"],
        # the teacher of the dry run's data-parallel distill step (world size 1, NCCL), and
        # a batch of 8 served from TF1-imported weights
        "dryrun_distill_launches": dp["dryrun_counts"]["fused_tail"],
        "tf1_import_serving_launches": tf1["counts"]["fused_tail"],
    }, {
        # forward and backward of a config-4 step's 12 warps (B=10, 224x480 down to 28x60;
        # dcoords on the 8 that need them) in one group call; launches: forward + backward
        # in the config-4 run; forward_ms: the group's forward alone; per_call_ms: the same
        # kernels once a warp; device_ms: the sampler kernels' device time in a config-4
        # step (profile_step); the bound reads each of the 4 images once
        "name": "bilinear_sample", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/bilinear_sample.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_sample.py:97",
        "launches": training["bilinear_sample"] + training["bilinear_sample_bwd"],
        "max_abs_err": sample_errs["out"],
        "ms": srow["group_fwdbwd"], "plain_ms": srow["plain_fwdbwd"],
        "forward_ms": srow["group_fwd"], "per_call_ms": srow["calls_fwdbwd"],
        "device_ms": srow["device_ms"],
        "bound_ms": srow["bound_fwd"] + srow["bound_bwd"], "bound_by": srow["bound_by"],
        # grid_sample(bilinear, zeros, align_corners=True), forward and backward for the
        # grid: the closest library call, not the same function (normalised coordinates,
        # no wmask)
        "library_ms": srow["grid_sample_fwdbwd"],
        # the L/R family's runs (5 steps each; 16 samplings a step, dimgs on 8), the
        # largest differences of its mixed C=3 / C=1 group from the plain version, and
        # the sampler kernels' device time in a bf16 lr_full step (profile_step)
        "lr_full_launches": demon["lr_full"]["bilinear_sample"]
        + demon["lr_full"]["bilinear_sample_bwd"],
        "lr_gt_launches": demon["lr_gt"]["bilinear_sample"]
        + demon["lr_gt"]["bilinear_sample_bwd"],
        "lr_group_max_abs_err": {k: lr_sample_errs[k] for k in ("out", "wmask", "dcoords",
                                                                 "dimgs")},
        "lr_group_ms": lr_sample_errs["group"]["ms"],
        "lr_group_device_ms": lr_sample_errs["group"]["device_ms"],
        "lr_group_plain_ms": lr_sample_errs["plain"]["ms"],
        "lr_group_bound_ms": lr_sample_errs["bound_ms"],
        "lr_full_device_ms": demon_times["lr_full"]["kernel"]["sampler_ms"],
        # the colon-pair runs on a "pallas" preset (5 steps each): forward + backward
        # launches; ms/step of the timed presets' bf16 steps with sampler="pallas" and
        # "xla" (8 rounds of 5) and the median of the rounds' paired differences, and the
        # sampler kernels' device time a step (profile_step)
        **{f"{mode}_launches": colon_counts[mode]["bilinear_sample"]
           + colon_counts[mode]["bilinear_sample_bwd"]
           for mode in ("only_image", "optflow_only", "dim11")},
        **{f"{config}_step_ms": {**{k: colon_times[config][k]["ms"]
                                    for k in ("pallas", "xla")},
                                 "median_diff": colon_times[config]["median_diff"]}
           for config in COLON_TIMED},
        **{f"{config}_device_ms": colon_times[config]["sampler_ms"]
           for config in COLON_TIMED},
        # refinement (20 f32 steps at 224x224, B=1, 4 warps a step): forward + backward
        # launches in phase 40's run (0 where the preset is "xla"), ms/step on both routes
        # with the median paired difference, and the sampler kernels' device time a step
        # of the "pallas" route (profile_step)
        "refine_launches": rf_counts["bilinear_sample"] + rf_counts["bilinear_sample_bwd"],
        "refine_step_ms": rf_step_ms, "refine_device_ms": rf_times["pallas"]["sampler_ms"],
    }, {
        # forward and backward of a config-4 step's group (12 maps, B=10, 224x480 down to
        # 28x60); launches: forward + backward in the config-4 run; per_map_loop_ms: the
        # same kernels called once a map; device_ms: the kernels' device time in a config-4
        # step (profile_step)
        "name": "smoothness", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/smoothness.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_losses.py:140",
        "launches": training["smoothness_fwd"] + training["smoothness_bwd"],
        "max_abs_err": smooth_errs["fwd"],
        "ms": mrow["group_fwdbwd"], "plain_ms": mrow["plain_fwdbwd"],
        "per_map_loop_ms": mrow["loop_fwdbwd"], "device_ms": mrow["device_ms"],
        "bound_ms": mrow["bound_fwd"] + mrow["bound_bwd"], "bound_by": mrow["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
        # forward + backward in the depth_only --turbo colon run (5 steps, 2 validations)
        "depth_only_turbo_launches": (c2t["counts"]["smoothness_fwd"]
                                      + c2t["counts"]["smoothness_bwd"]),
        # forward + backward in the config-5 and L/R runs (5 steps each)
        **{f"{c}_launches": demon[c]["smoothness_fwd"] + demon[c]["smoothness_bwd"]
           for c in DEMON_PER_STEP},
        # forward + backward in the colon-pair runs (5 steps each; optflow3 and sfm 12
        # channel views a group, optflow_only 8 flow planes)
        **{f"{m}_launches": colon_counts[m]["smoothness_fwd"]
           + colon_counts[m]["smoothness_bwd"] for m in COLON_MODES},
        **{f"{config}_device_ms": colon_times[config]["smooth_ms"] for config in COLON_TIMED},
        # refinement: forward + backward launches in phase 40's run (4 maps a step), the
        # step's ms/step as for bilinear_sample, the kernels' device time a step of the
        # preset's route (profile_step)
        "refine_launches": rf_counts["smoothness_fwd"] + rf_counts["smoothness_bwd"],
        "refine_step_ms": rf_step_ms,
        "refine_device_ms": rf_times[refine.SAMPLER]["smooth_ms"],
        # forward + backward in the data-parallel config-2 run (5 steps, world size 1,
        # NCCL), in depth_only --native_loader (5 steps; None where the loader cannot
        # build) and depth_only --rich_summaries (5 steps)
        "dp_launches": sum(n["smoothness_fwd"] + n["smoothness_bwd"] for n in dp["per_step"]),
        "native_loader_launches": (None if nat["counts"]["smoothness_fwd"] is None else
                                   nat["counts"]["smoothness_fwd"]
                                   + nat["counts"]["smoothness_bwd"]),
        "rich_summaries_launches": (summ["depth_only"]["smoothness_fwd"]
                                    + summ["depth_only"]["smoothness_bwd"]),
    }, {
        # forward and backward of phase 2's group of a step (4 pairs, B=1, 192x256 down to
        # 24x32, delta 2); launches: forward + backward in both phases' runs;
        # per_map_loop_ms: the same kernels called once a pair; device_ms: the kernels'
        # device time in a phase-2 step (profile_step)
        "name": "sig_l2", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/sig_l2.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_losses.py:63",
        "launches": sum(split[p]["sig_fwd"] + split[p]["sig_bwd"] for p in SIG_PER_STEP),
        "max_abs_err": sig_errs["fwd"],
        "ms": sig_row["group_fwdbwd"], "plain_ms": sig_row["plain_fwdbwd"],
        "per_map_loop_ms": sig_row["loop_fwdbwd"],
        "device_ms": split_rows[("split_single", "kernel")]["sig_ms"],
        "bound_ms": sig_row["bound_fwd"] + sig_row["bound_bwd"],
        "bound_by": sig_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
        # forward + backward in the lr_gt run (5 steps; the 5-delta term at 192x256, B=16)
        "lr_gt_launches": demon["lr_gt"]["sig_fwd"] + demon["lr_gt"]["sig_bwd"],
        # forward + backward in the dry run's 3 data-parallel pairwise steps (world size 1,
        # NCCL; B=2, 32x64) and split_training phase 1 --rich_summaries (5 steps)
        "dryrun_launches": dp["dryrun_counts"]["sig_fwd"] + dp["dryrun_counts"]["sig_bwd"],
        "rich_summaries_launches": summ["split"]["sig_fwd"] + summ["split"]["sig_bwd"],
    }, {
        # forward and backward (dcoords) of a config-3 step's 4 warps (B=16, 192x256 down to
        # 24x32) in one group call, on the kernels of csrc/bilinear_sample.cu; launches:
        # forward + backward in the config-3 run; forward_ms, per_call_ms and device_ms as
        # for bilinear_sample (device_ms from a config-3 step)
        "name": "bilinear_sample_fused", "route": "cuda",
        "source": "tf_depth_estimation_torch/csrc/bilinear_sample.cu",
        "replaces": "tf_depth_estimation_tpu/ops/pallas_warp.py:51",
        "launches": c3_counts["fused_fwd"] + c3_counts["fused_bwd"],
        "max_abs_err": fused_errs["out"],
        "ms": frow["group_fwdbwd"], "plain_ms": frow["plain_fwdbwd"],
        "forward_ms": frow["group_fwd"], "per_call_ms": frow["calls_fwdbwd"],
        "device_ms": frow["device_ms"],
        "bound_ms": frow["bound_fwd"] + frow["bound_bwd"], "bound_by": frow["bound_by"],
        # grid_sample as for bilinear_sample: the closest library call, not the same function
        "library_ms": frow["grid_sample_fwdbwd"],
    }]
    for name, replaces in (("dot_loop", "tools/probe_int8_dot.py:29"),
                           ("dot_grid", "tools/probe_int8_dot2.py:60")):
        # int8, the probes' question, at their shapes; bf16 beside it; launches: the
        # probe tool's run (both dtypes), with the int8 transposes of B and the loop's sums
        # of its K parts beside them; library: torch._int_mm (R in turn for dot_loop)
        row, bf16 = prow[(name, "int8")], prow[(name, "bf16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tf_depth_estimation_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": probe_counts[name],
            "transpose_launches": probe_counts[f"{name}_transposes"],
            "reduce_launches": probe_counts.get(f"{name}_reduces", 0),
            "max_abs_err": probe_errs[(name, "int8")], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_colmajor_ms": row["library_colmajor_ms"],
            "bf16": {"max_abs_err": probe_errs[(name, "bf16")], "ms": bf16["ms"],
                     "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
                     "library_ms": bf16["library_ms"]},
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {info['smi']}")
    # a device time a profiler session lost (None) is left out: not measured
    kernels = [{k: v for k, v in row.items() if v is not None or k == "library_ms"}
               for row in kernels]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}))


if __name__ == "__main__":
    main()
