#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (unet_convlstm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

It runs the phases below, each printing JSON lines; any failure exits
non-zero:

1. device   — the card's name and power limit (nvidia-smi), the build of
              every kernel from ``unet_convlstm_tpu_torch/csrc``, and
              ptxas's registers and spills of the fused conv's kernels.
2. kernel   — each kernel against its plain PyTorch version on the card,
              with its device time, the plain version's, a library
              yardstick's and the least time the card could take (bound):
              the forward kernels at the serving path's shapes (B=4, T=4,
              128x128, base_ch 64), and the gate update's backward (bf16
              and f32), the forward gate update and the fused conv at the
              training path's shapes (B=64, T=10, 64x64, base_ch 32).
3. serve    — a base_ch-64 TemporalUNetDualView from a seeded generator,
              saved as a .pt with a norm_stats manifest and served through
              StreamingPredictor(device="cuda"): 2 sessions x 3 requests of
              4 frames with the launch counts read around them, then
              streaming, predict_many, HTTP and kernels-on vs plain checks.
4. latency  — request latency over 100 requests per geometry, and where
              one request's device time goes (torch.profiler).
5. train    — the training step of the JAX package's benchmark (Moving-
              MNIST B=64, T=10, 64x64, base_ch 32, bf16, AdamW): 3 steps
              with the launch counts read around them, the kernel path
              against the plain path (f32 and bf16), a NaN batch under the
              non-finite skip, step times over 20 steps per path, peak
              memory, and where one step's device time goes.
6. mc       — stage B's Monte-Carlo path tracer at the production geometry
              (two 128x128x200 patches, a 256x256 view from 600 km, spp 16,
              max_depth 64): the fused-sampler route (K4, one launch per
              lockstep iteration) at majorant cells 0 and 16 and the threefry
              route at each patch's auto cell, with launch counts, wall
              times, iterations and image means; fused against threefry
              within 4 standard errors; the threefry route on the card
              against the same code on the CPU; one profiled view.
7. renders  — ``gen-renders`` of the port's CLI on two such patches and a
              2-view overpass CSV: deterministic, MC at spp 16, batched;
              pkl schema, batched = serial, a re-run byte-equal.
8. probes   — both probe entry points at their default sizes through
              ``python -m`` as a user runs them (the BN-statistics probe
              with K6 at [640, 64, 64, 32] bf16, the gather probe with K7 at
              its five shapes), their lines and launch counts.
9. fit      — the training run through the port's CLI at full width
              (configs/mnist_small.json: base_ch 32, B=32, T=10, 64x64):
              gen-mnist (2,000 sequences), train 2 epochs, resume for a
              third, exact launch counts per epoch, history.csv, one request
              served from the best checkpoint, then one more epoch with
              ``--profile-dir`` (the loop's trace of steps 10-20): epoch
              time, frames/s and the device's busy share; and the host's
              data path alone (gather, gather + copies to the card).
10. overfit — the memorization gate through the CLI (base_ch 16, 4
              sequences, 300 steps): launch counts, the loss per chunk
              finite and falling.
11. resnet  — the ResNet18 family (configs/cloud_resnet.json's model:
              lstm_layers 2, in_channels 2, the encoder frozen on a .pth
              written by save_resnet18_encoder_pth from a seeded model):
              K1 forward and backward (bf16) at its five levels of both
              paths (C = 512, 256, 128, 64, 64); serving at B=4, T=4,
              128x128 (40 K1 launches a request, no K2), the serving
              checks, latency and a profiled request; the training step at
              B=32, T=12, 128x128 (120 K1 forward and 120 backward launches
              a step), the encoder bit-equal after 3 steps, kernels against
              plain, step times, peak memory, a profiled step, then one
              step unfrozen; the CLI's train, a resume after the .pth is
              deleted, and one request served from resnet18_best.pt.
12. eval    — evaluation and rollout: ``evaluate`` through the CLI on
              phase 9's best checkpoint (its MAE equals the best epoch's
              val MAE to the 4 printed decimals; report.json's fields);
              ``evaluate_model`` at configs/cloud_wvu.json's width (base_ch
              64, 3 output channels, 128x128, T=12, B=16) on a seeded npz
              of 64 sequences; the streaming, whole-sequence and prefix
              rollouts at base_ch 64, 128x128, T=12, B=1 in f32; and
              ``rollout`` through the CLI (the per-frame CSV; the video and
              the figures where matplotlib and cv2 import), each with its
              exact K1 and K2 launch counts.
13. int8    — post-training int8 at scripts/perf/bench_int8.py's geometry
              (base_ch 64, 128x128, T=12, B=8): quantize_model of a seeded
              checkpoint, one forward's exact K8 (by route, every call on
              the quantizing entry) and K1 launches and no K2,
              K8 against its plain version through the whole forward,
              int8 against bf16 (the JAX test's 0.06 PTQ bound with
              BatchNorm at init; with calibrated BatchNorm reported),
              calibrate_tree on 4 batches, int8 serving (dynamic, and
              calibrated on frame blocks given as a generator) with one
              HTTP round trip, forward time, request latency and a
              profiled request of int8 dynamic, int8 calibrated and bf16
              (the calibrated request runs no round or two-sided clamp
              kernel beyond the bf16 request's: the quantizer is in K8),
              ``evaluate --int8 --int8-calib 2`` through the CLI on phase
              9's checkpoint (its MAE against the bf16 one; dynamic int8
              through evaluate_model with K8 equal to it with K8's plain
              version), and one int8 request of the ResNet18 family.
14. datachain — the data chain: stage A's microphysics on the card against
              float64 numpy at a BOMEX-like block; stage C (``gen-maps``) at
              the production geometry (the gate's 128x128x32 patches at
              20 m, 256x256, a 2-view overpass CSV, slice and first_hit):
              serial and --batch 8 on the card, timed a patch, against the
              same call on the CPU, with the fixed nadir camera and with the
              CSV's own cameras; ``cloud-gate --production`` through the CLI
              (the custom model at base_ch 64, 128x128, T=2, B=4, 10 epochs,
              the deterministic stage-B renderer): PASSED and exit 0, each
              stage's wall time, the first, best and final val MAE, the K1
              and K2 launches of its training run exact; and the gate at
              nz 8, nxy 16 with stage B on the Monte-Carlo path tracer
              (spp 4, majorant cell 16), its renders reaching stage D.
15. surface — the rest of the single-card surface: the native gather
              (g++ at first use) bit-equal to numpy's two passes at the fit
              phase's batch and at one cloud batch (configs/cloud_wvu.json's
              channels, B=16, T=12, 128x128), both routes timed on the
              host; gen-mnist's npz byte-equal to the generator with the
              numpy paste; make_grain_loader (DataLoader) at 0 and 2
              workers, 2 shuffled epochs covering the train split;
              convert-checkpoint --to-torch then --torch-ckpt bit-equal,
              --quantize then ``evaluate`` of the int8 copy equal to
              ``evaluate --int8`` with exact K1 and K8 launches and no K2;
              ``stats`` against numpy, ``inspect`` on phase 14's pkls and an
              .nc; ``doctor`` exit 0 with every line PASS; the viz modules'
              numbers against numpy and each drawing drawn or said not
              drawn. Phase 9 counts its gathers by route (all native).
16. repro   — a training run reproducible on the card: K2 20 times at each
              shape of the training step from the same inputs (y, the sums
              and the sums of squares bit-identical: K2 adds its per-channel
              sums in a fixed order); three training steps of the benchmark's
              configuration (B=64, T=10, 64x64, base_ch 32, bf16) twice from
              one seed (losses, parameters and BatchNorm statistics
              bit-identical); ``cloud-gate --production`` a second time, its
              best val MAE bit-equal to phase 14's (the spread of three
              runs from before the fix printed beside it). The training
              paths (phase 5's step, ``fit`` and the gate) run under
              ``core.determinism.deterministic``.
17. dp      — data parallelism on the one card: two gloo ranks spawned on
              cuda:0 (gloo takes CUDA tensors for the all-reduce and the
              all-gather the port calls) run three steps of the benchmark's
              configuration, 32 rows a rank, against one process at B=64,
              each step from the same state on both sides, in bf16 (the
              main path) and in f32: loss, metric sums, parameters and
              BatchNorm statistics within bounds, and per-rank BatchNorm
              statistics (a control) beyond them; ZeRO-1 against
              replicated on the ranks (bit-equal); K1 forward, backward
              and K2 launches
              per rank per step exact; ``evaluate_model`` and
              ``rollout_scan`` on the ranks against one process; whether
              gloo itself takes CUDA tensors; an NCCL group of world size 1
              running the same data-parallel step bit-equal to no group.
              Multi-rank NCCL is not run (one card): unverified. The two
              ranks' step times share one card and are no data-parallel
              speed.
18. tp      — tensor parallelism on the one card: K2 against its plain
              version at every Cout/2 shape of a rank's step (64 and 32
              rows), timed; then gloo ranks spawned on cuda:0 at a (data 1,
              model 2) and a (data 2, model 2) mesh, each conv kernel and
              its AdamW moments split by output channel over the model
              ranks (the JAX rule), run three bf16 and three f32 steps of
              the benchmark's configuration against one process, each step
              from the same state (ZeRO-1 on top at data 2, bit-equal to
              replicated moments); the replicated leaves and the gathered
              shards the same bits on every rank; K1 forward, backward and
              K2 launches per rank per step exact, K2 on the wgmma route;
              ``evaluate_model`` with ``variables_sharding`` and
              ``rollout_scan`` against one process; gloo's CUDA support on
              the grid's groups. The ranks' step times share one card and
              are no tensor-parallel speed; multi-rank NCCL is unverified.
19. mesh    — the rest of the mesh surface: make_multi_train_step at K=4
              in one process against 4 calls of make_train_step from the
              same init (bit-equal, launches exactly 4x a step's); one
              step with remat against one without (loss, gradients,
              parameters and BatchNorm statistics bit-equal; peak memory
              and launches both ways) and with flat_layout "batch" against
              "time"; then two gloo ranks sharing cuda:0: the multi-step
              at K=2 against two data-parallel steps (bit-equal), the
              benchmark model's bottleneck ConvLSTM (512 -> 512 at 4x4,
              B=64) pipelined over time at T=10 and 9 and microbatches 1,
              2 and 4 against convlstm in one process in f32 and bf16 (K1
              launches per rank exact), stage B (phase 7's patches and
              CSV, deterministic and MC at spp 16) and stage C (phase 14's
              patches, both modes) over the ranks, byte-equal to one
              process; the CLI's --data-parallel in one process equal to
              --batch, and under torchrun with two CPU ranks equal to one
              process; whether gloo's own send takes CUDA tensors
              (recorded: the port stages them through the host). No
              parallel speed; multi-rank NCCL unverified.
20. drivers — the examples and run drivers through ``python -m`` as a
              user runs them (no --device: the card), all six at once, cut
              to seconds: library_quickstart at its defaults (its
              evaluation MAE equal to the best epoch's val MAE), render_one
              on the debug volume at 64x64 (views.npz, the alignment
              number), run_resnet_golden and pretrain_encoder at a few
              samples and 1 epoch (the .pth freezes an encoder equal to the
              checkpoint's), run_mnist_T40 at 32 samples over two process
              generations, run_endurance_200ep at 4 epochs killed after 2
              (the seam judged); the K1 and K2 launches of each (child
              processes included) exact; then the rbg stream: uniforms on
              the card bit-equal to the CPU's, and one rbg view at phase
              6's geometry (the dense patch) on the threefry chain and on
              the fused route (K4 once an iteration), each mean within 4
              standard errors of the threefry view's.

Phase 2 also holds the gate update forward (K1) where its vector route does
not go (C = 12, a gates view 2 bytes off a 16-byte boundary), with f32
gates, zero rows and gates holding +-inf and NaN; the fused MC sampling
kernels (K4 with its Philox uniforms, K5 with given uniforms) against their
plain versions at one view (65,536 lanes) and at the MC main path's launch
(16 rounds of a view), the channel statistics kernel (K6) at the probe's
activation and at ragged shapes, and the chained gather kernel (K7) at the
gather probe's five shapes, on negative, out-of-range values, where the
last tile of lines is short (in both shared-memory layouts) and at the
longest line it takes along each axis, beside its latency floor (one
block's 64 dependent shared loads), and the int8 conv (K8) at every
distinct conv shape of the two int8 paths (phase 13's forward and the
ResNet18 family's int8 request) and at ragged shapes (Cin 2 and 20 on the
byte-gather loader, Cout 1, 12 and 30 on the vec loader; on the wgmma route
Cin 16 and 48, pixel and column counts off the tile, split K, stride 2 on
an odd input, odd transposed convs) and on an x off a 16-byte boundary:
both entries (an int8 x; a bf16 or f32 x quantized in the kernel with a
static or a dynamic scale) bit-equal to their plain versions in f32 and
bf16, each shape timed (the quantizing entry on a bf16 x with a calibrated
static scale, as the calibrated main path calls it; its dynamic and
int8-input variants) beside cuDNN's bf16 conv at the shape and
torch._int_mm at the GEMM's (M, N, K) (reference points, not the same
function). The main-path phases count K1's launches by route (all on the
vector route) as they do K2's, and phase 13 K8's by route and by entry.

The last three lines are the card's name and power limit as nvidia-smi
gives them, {"kernels": [...]}, and {"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": ...}}. Without a card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import datetime
import functools
import csv
import glob
import hashlib
import http.client
import importlib.util
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from unet_convlstm_tpu_torch import benchmark
from unet_convlstm_tpu_torch.cli import main as cli_main
from unet_convlstm_tpu_torch.data import fast_gather, moving_mnist
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset
from unet_convlstm_tpu_torch.data.pipeline import (SequenceLoader,
                                                  prefetch_to_device)
from unet_convlstm_tpu_torch.core.determinism import (
    deterministic, set_cublas_workspace_config)
from unet_convlstm_tpu_torch.core.dtypes import (DEFAULT_POLICY, FP32_POLICY,
                                                 full_fp32)
from unet_convlstm_tpu_torch.core import random as rnd
from unet_convlstm_tpu_torch.datagen import mc_reference
from unet_convlstm_tpu_torch.datagen.microphysics import process_cloud_vars
from unet_convlstm_tpu_torch.datagen.overpass import synthesize_overpass_csv
from unet_convlstm_tpu_torch.datagen.render_batch import render_dataset
from unet_convlstm_tpu_torch.datagen.velocity_maps import build_velocity_maps
from unet_convlstm_tpu_torch.datagen.renderer import (VolumeScene,
                                                      sun_transmittance)
from unet_convlstm_tpu_torch.eval import (EvalReport, evaluate_model,
                                          rollout_prefix_rerun, rollout_scan,
                                          rollout_streaming)
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.native import build as host_build
from unet_convlstm_tpu_torch.models.temporal_unet import temporal_unet_apply
from unet_convlstm_tpu_torch.ops.kernels import (build, chained_gather,
                                                 channel_stats, conv_int8,
                                                 convlstm_fused,
                                                 doubleconv_fused,
                                                 launch_counts, mc_sampler,
                                                 reset_launches)
from unet_convlstm_tpu_torch.ops.convlstm import convlstm
from unet_convlstm_tpu_torch.ops.convlstm_sp import convlstm_time_pipelined
from unet_convlstm_tpu_torch.ops.losses import compute_loss
from unet_convlstm_tpu_torch.ops.normalize import (NormStats, compute_mask,
                                                   compute_norm_stats,
                                                   normalize_x, normalize_y)
from unet_convlstm_tpu_torch.ops.quant import (calibrate_tree,
                                               quant_sites, quantize_model)
from unet_convlstm_tpu_torch.parallel.mesh import MeshRules, make_mesh
from unet_convlstm_tpu_torch.parallel.tensor import (full_state_dict,
                                                     shard_model)
from unet_convlstm_tpu_torch.probes import bn_kernel_proto, probe_gather
from unet_convlstm_tpu_torch.serve import StreamingPredictor, serve_http
from unet_convlstm_tpu_torch.train import cloud_gate
from unet_convlstm_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.loop import PROFILE_STEPS, _trainable_mask
from unet_convlstm_tpu_torch.train.optim import make_optimizer
from unet_convlstm_tpu_torch.train.metrics import MetricSums
from unet_convlstm_tpu_torch.train.steps import (make_multi_train_step,
                                                 make_train_step)
from unet_convlstm_tpu_torch.utils.torch_weights import (
    save_resnet18_encoder_pth)

# the local process groups of phase 17 (a test-support module of the repo)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from _torch_ranks import free_port, run_local_ranks, to_host  # noqa: E402

# cuBLAS reads its deterministic workspace setting at its first handle: set
# before CUDA starts (the training paths run deterministic)
set_cublas_workspace_config()

SEED = 0
B, T, HW, BASE = 4, 4, 128, 64           # the serving path's geometry
REQUESTS_PER_SESSION, SESSIONS = 3, 2
LATENCY_REQUESTS = 100                   # p90 then has 10 samples beyond it
# the training path: the JAX package's benchmark configuration
TB, TT, THW = benchmark.B, benchmark.T, benchmark.H
TBASE = benchmark.MODEL_CFG["base_ch"]
TRAIN_STEPS, TIMED_STEPS, LR = 3, 20, 1e-3
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
BF16_OPS_PER_S = 989e12                  # dense tensor-core bf16, same
L2_BYTES = 50 * 2 ** 20
DEV = torch.device("cuda")
# stage B at the production geometry (scripts/perf/bench_mc.py:13-31)
MC_NZ, MC_NXY, MC_RES, MC_SPP, MC_DEPTH = 200, 128, 256, 16, 64
MC_LANES = MC_RES * MC_RES
MC_CAMERA = dict(origin=(0, 0, 600_000.0), target=(0, 0, 1500.0),
                 up=(1.0, 0.0, 0.0), fov_deg=0.25,
                 resolution=(MC_RES, MC_RES), sun_dir=(0.3, 0.2, -0.9),
                 g=0.85)
MC_CELLS = (0, 16)
MC_SE_LIMIT = 4          # fused vs threefry means, in standard errors
NO_LAUNCHES = {"mc_sample_flights": 0, "mc_sample_flights_uniforms": 0,
               "channel_sum_sumsq": 0, "chained_gather": 0, "conv_int8": 0}
F32_OPS_PER_S = 67e12                    # f32 outside the tensor cores, same
ROOT = os.path.dirname(os.path.abspath(__file__))
# the training run: configs/mnist_small.json, its data as the config says
FIT_CONFIG = os.path.join(ROOT, "configs", "mnist_small.json")
FIT_SAMPLES, FIT_EPOCHS = 2000, 2
OVERFIT_ITERS, OVERFIT_BASE, OVERFIT_SAMPLES = 300, 16, 4
# the ResNet18 family: configs/cloud_resnet.json's model (lstm_layers 2,
# in_channels 2, frozen encoder); its training geometry (BASELINE.md:59)
RESNET_CONFIG = os.path.join(ROOT, "configs", "cloud_resnet.json")
RB, RT, RHW = 32, 12, 128


def k1_levels(base, hw, t):
    """The gate updates of one pass: (level, hidden C, map side,
    launches)."""
    return [("bottleneck", 16 * base, hw // 16, t),
            ("skip3", 8 * base, hw // 8, t),
            ("skip2", 4 * base, hw // 4, t)]


def k2_convs(base, hw):
    """Every fused conv of one pass, as (H=W, cin, cout, prologue,
    launches). Level i has base * 2^i channels on hw / 2^i maps; conv1 of
    each DoubleConv has no prologue, conv2 applies BN1's. inc conv1
    (cin = 2) is a library conv and not in the list."""
    ch = [base << i for i in range(5)]
    side = [hw >> i for i in range(5)]
    convs = [(side[0], ch[0], ch[0], True)]                     # inc conv2
    for i in range(1, 5):                                       # down1..3,
        convs += [(side[i], ch[i - 1], ch[i], False),           # bottleneck
                  (side[i], ch[i], ch[i], True)]
    for i in range(3, -1, -1):                                  # up3..up0:
        convs += [(side[i], ch[i + 1], ch[i], False),           # concat in
                  (side[i], ch[i], ch[i], True)]
    return [(*conv, n) for conv, n in collections.Counter(convs).items()]


K1_LEVELS = k1_levels(BASE, HW, T)
K2_CONVS = k2_convs(BASE, HW)
K1_PER_REQUEST = sum(n for *_, n in K1_LEVELS)
K2_PER_REQUEST = sum(n for *_, n in K2_CONVS)
K1_TRAIN_LEVELS = k1_levels(TBASE, THW, TT)
K2_TRAIN_CONVS = k2_convs(TBASE, THW)
K1_PER_STEP = sum(n for *_, n in K1_TRAIN_LEVELS)       # forward = backward
K2_PER_STEP = sum(n for *_, n in K2_TRAIN_CONVS)

# tolerances, with their reasons
K1_TOL = ("h: 2^-8 absolute (one bf16 ulp of |h| <= 1: h is rounded to the "
          "gates' dtype); c: 1e-5 * (1 + |c|) (f32 exp/tanh of another "
          "library)")
K1_BWD_TOL = ("dc, and dgates in f32: 1e-5 * (1 + |x|) (f32 exp/tanh of "
              "another library, FMA contraction); dgates in bf16: 2^-7 * |x| "
              "+ 1e-5 (one bf16 ulp where the f32 values straddle a rounding "
              "boundary)")
K2_TOL = ("y: 2^-7 * |y| + 1e-3 * max|y| (the f32 sums run in another order, "
          "so a bf16 rounding may flip by one ulp); sum, sumsq: 1e-3 of the "
          "sum of |y| resp. of sumsq (f32 sums in another order than the "
          "plain version's)")
K2_F32_TOL = "y: 1e-4 * max|y| (f32 FMA in another order)"
K2_RERUN_TOL = ("y, sum and sumsq bit-equal in a second run on both routes "
                "(K and the per-channel sums are reduced in fixed orders, "
                "split K included); NaNs where the plain version has them")
MC_K_TOL = ("u_acc bit-equal; t 1e-6 relative (log1p, a few ulps); new_d "
            "within 1e-5 per component in all but 0.01% of lanes and 1e-3 "
            "in all (an ulp of cos theta near +-1 moves sin theta by up to "
            "3.5e-4), unit norm 1e-5")
MC_CROSS_TOL = ("threefry route, card against CPU: image mean 1e-4 relative, "
                "at most 1% of pixels beyond 1e-4 relative (a last-ulp "
                "difference of log/cos may send a lane to another voxel)")
K6_TOL = ("sum: 1e-5 of the channel's sum of |x|; sumsq: 1e-5 relative (f32 "
          "sums in another order); bit-equal from run to run; the means "
          "within 1e-5, tighter than the probe script's 2e-3")
K7_TOL = "bit-equal (the same f32 adds in link order, the same int32 math)"
STREAM_TOL = 1e-2   # RMS error over RMS |y|: cuDNN's bf16 convs may pick
#                     other algorithms for another batch size, which rounds
#                     otherwise (a bf16 ulp is 2^-8); a lost or misrouted
#                     state would be off by O(1)
# The whole forward, kernels on against the plain path. In f32 they compute
# the same sums in another order: 1e-3 of max|y|. In bf16 they round at
# other places (the kernels add the bias in f32 and apply BN1 in f32 in the
# prologue, the library path rounds after each), and bf16 alone puts either
# path a few % (RMS) off the f32 forward on this calibrated random model.
# So in bf16 the kernel path's RMS error against the f32 forward may be at
# most 1.25 times the plain path's, and at most 10%.
PATH_F32_TOL = 1e-3
PATH_BF16_VS_F32_RATIO = 1.25
PATH_BF16_RMS_TOL = 0.1
# The training step, kernels on against the plain path, each step from the
# same state (f32, TF32 off): the loss and the metric sums within 1e-4
# (train-mode BN and the loss are sums in another order; the signed error
# sum is taken relative to the |error| sum); the first gradients within
# 1e-3 of their global norm; the parameters after a step in units of the
# learning rate, since AdamW's first updates move each element by about
# +-lr whatever the gradient's size: at most 0.5% of the elements may have
# moved differently by more than lr/2 (the sign of a gradient below the
# paths' f32 difference is noise), and the rest within an RMS of 5e-2 lr
# (the first update, g / (|g| + eps), turns a gradient difference into a
# fraction of lr where |g| is near eps = 1e-8: 0.024 lr RMS measured at the
# first step on an H100, 0.001 at the later ones); the BN running stats
# within 1e-4 of max(1, max|stat|) of each buffer.
TRAIN_F32_TOL = dict(loss=1e-4, sums=1e-4, grad=1e-3, params_flipped=5e-3,
                     params_rms_lr=5e-2, bn=1e-4)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def path_counts():
    """``launch_counts()`` with the gate update forward's and the fused
    conv's calls by route."""
    return dict(launch_counts(), **{
        f"gate_update_{route}": n
        for route, n in convlstm_fused.launches_by_route.items()}, **{
        f"conv3x3_fused_{route}": n
        for route, n in doubleconv_fused.launches_by_route.items()})


def on_main_routes(expect):
    """An expectation of ``path_counts()``: every gate update of a main path
    takes the vector route, and every fused-conv call of a bf16 main path
    the wgmma route."""
    return dict(expect, gate_update_vector=expect["gate_update"],
                gate_update_scalar=0,
                conv3x3_fused_wgmma=expect["conv3x3_fused"],
                conv3x3_fused_generic=0)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rms_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS of a - b over RMS of b."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def device_ms(fn, arg_sets, n: int = 20) -> float:
    """Device time of one ``fn(*args)``, in ms: ``n`` calls cycling over
    ``arg_sets`` (copies that together exceed the L2 cache, so that each
    call reads device memory as on the path) are enqueued behind a spin
    kernel, so the events time the device's work and not the host's."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[0])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # spin long enough (at <= 2 GHz) for the host to enqueue all n calls
    torch.cuda._sleep(int(min(2e9, 4e9 * host_s * n + 2e6)))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def copies(make, nbytes: int):
    """Enough independent input sets to exceed twice the L2 cache."""
    k = max(2, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(k)]


# ---------------------------------------------------------------------------
# 1. device and build
# ---------------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_s = build.build_all()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "build_wall_s": time.perf_counter() - t0})
    for src in ("conv3x3_fused", "conv_int8"):
        emit(dict(phase="ptxas", source=f"{src}.cu", **ptxas_report(
            (build.build_dir() / f"{src}.log").read_text(), src)))
    return smi


def ptxas_report(log: str, prefix: str = "conv3x3_fused") -> dict:
    """Registers and spill bytes of each kernel whose name starts with
    ``prefix`` in an ``nvcc -Xptxas -v`` log, and the count of C7517
    warnings (a wgmma wait the compiler injected, which serialises the
    asynchronous products)."""
    kernels, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d(" + prefix
                      + r"\w*?_kernel)(I\w+?EE)?", line)
        if m:   # template arguments: ints and bools as values, types named
            args = re.findall(r"Li(\d+)E|Lb(\d)E|(13__nv_bfloat16)|(f)|(a)",
                              (m.group(2) or "")[1:])
            args = [i or t or ("bf16" if b else "f32" if f else "s8")
                    for i, t, b, f, _ in args]
            name = m.group(1) + ("<" + ",".join(args) + ">" if args else "")
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            kernels.setdefault(name, {})["spill_bytes"] = int(spill.group(1))
        if name and regs:
            kernels.setdefault(name, {})["registers"] = int(regs.group(1))
    return {"kernels": kernels, "c7517": log.count("C7517")}


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions, timed
# ---------------------------------------------------------------------------

def _total():
    return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0)


def _k1_errors(gates, c):
    """(ok, |dh| max, |dc| / (1 + |c|) max, bits equal in a rerun) of K1
    forward against its plain version with K1_TOL, over the finite plain
    outputs; the non-finite ones must be the same (NaN where NaN, the same
    inf)."""
    h_k, c_k = convlstm_fused.fused_gate_update(gates, c)
    h_k2, c_k2 = convlstm_fused.fused_gate_update(gates, c)
    h_p, c_p = convlstm_fused.gate_update_plain(gates, c)
    torch.cuda.synchronize()
    rerun = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in ((h_k, h_k2), (c_k, c_k2)))
    hk, hp = h_k.float(), h_p.float()
    dh = dc = 0.0
    same = all(torch.equal(torch.isnan(k), torch.isnan(p))
               and torch.equal(k[torch.isinf(p)], p[torch.isinf(p)])
               for k, p in ((hk, hp), (c_k, c_p)))
    fin = torch.isfinite(hp) & torch.isfinite(c_p)
    if fin.any():
        dh = (hk - hp).abs()[fin].max().item()
        dc = ((c_k - c_p).abs() / (1 + c_p.abs()))[fin].max().item()
    return same and dh <= 2 ** -8 and dc <= 1e-5, dh, dc, rerun


def _k1_plan(gates, c):
    p = convlstm_fused.plan_for(gates, c)
    return {"route": p.route, "plan": {"vec": p.vec, "blocks": p.blocks}}


def check_k1(gen, levels, batch, per, path=None):
    """K1 forward at the recurrence levels of a pass: checks and times per
    pass (``per``: request or step; ``path``: the model family's tag on
    each line, none for the custom model). ``ms`` rotates its inputs past
    the L2 cache; ``ms_inputs_in_l2`` reuses one set, as a path whose gates
    come straight from the gate conv may find them."""
    total = _total()
    for level, C, side, launches in levels:
        rows = batch * side * side

        def make():
            gates = torch.randn(rows, 4 * C, device=DEV, generator=gen) * 2
            return (gates.to(torch.bfloat16),
                    torch.randn(rows, C, device=DEV, generator=gen))

        gates, c = make()
        ok, dh, dc, rerun = _k1_errors(gates, c)
        plan = _k1_plan(gates, c)
        ok = ok and rerun and plan["route"] == "vector"
        nbytes = rows * C * (4 * 2 + 4 + 2 + 4)
        args = copies(make, nbytes)
        ms = device_ms(convlstm_fused.fused_gate_update, args)
        plain_ms = device_ms(convlstm_fused.gate_update_plain, args)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        emit({"phase": "kernel", "kernel": "gate_update", "level": level,
              **({"path": path} if path else {}),
              "rows": rows, "C": C, "MB": nbytes / 1e6, "dtype": "bfloat16",
              **plan, "h_abs_err": dh, "c_rel_err": dc,
              "bit_equal_rerun": rerun, "ok": ok, "ms": ms,
              "ms_inputs_in_l2": device_ms(convlstm_fused.fused_gate_update,
                                           args[:1]),
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "pct_of_bound": 100 * bound_ms / ms,
              f"launches_per_{per}": launches})
        if not ok:
            raise AssertionError(f"gate_update disagrees at {level}")
        total["ms"] += ms * launches
        total["plain_ms"] += plain_ms * launches
        total["bound_ms"] += bound_ms * launches
        total["max_abs_err"] = max(total["max_abs_err"], dh, dc)
    return total


def check_k1_edges(gen):
    """K1 forward where the vector route does not go, or goes with other
    data: C = 12 and a gates view 2 bytes off a 16-byte boundary (the scalar
    route), f32 gates (4-channel vectors), zero rows (no launch), and gates
    holding +-inf and NaN, which must come out as the plain version's."""
    def r(*shape):
        return torch.randn(*shape, device=DEV, generator=gen)

    buf = (r(1024 * 4 * 64 + 1) * 2).to(torch.bfloat16)
    odd = (r(1024, 4 * 64) * 2).to(torch.bfloat16)
    odd[0, :8] = float("inf")
    odd[1, 64:72] = -float("inf")
    odd[2, 128:136] = float("nan")
    odd[3, 3] = float("nan")
    odd[4, 200] = float("inf")
    odd[5, 70] = -float("inf")
    cases = [("c12_scalar", (r(1000, 48) * 2).to(torch.bfloat16),
              r(1000, 12), "scalar"),
             ("offset_view_scalar", buf[1:].view(1024, 4 * 64), r(1024, 64),
              "scalar"),
             ("f32_gates", r(4096, 4 * 256) * 2, r(4096, 256), "vector"),
             ("inf_nan_gates", odd, r(1024, 64), "vector")]
    worst = 0.0
    for name, gates, c, route in cases:
        ok, dh, dc, rerun = _k1_errors(gates, c)
        plan = _k1_plan(gates, c)
        ok = ok and rerun and plan["route"] == route
        line = {"phase": "kernel", "kernel": "gate_update", "case": name,
                "rows": c.shape[0], "C": c.shape[1],
                "dtype": str(gates.dtype).split(".")[-1], **plan,
                "h_abs_err": dh, "c_rel_err": dc, "bit_equal_rerun": rerun,
                "ok": ok}
        emit(line)
        if not ok:
            raise AssertionError(f"gate_update edge case failed: {line}")
        worst = max(worst, dh, dc)
    before = convlstm_fused.launches
    h, c_next = convlstm_fused.fused_gate_update(
        torch.empty(0, 4 * 64, device=DEV, dtype=torch.bfloat16),
        torch.empty(0, 64, device=DEV))
    ok = (h.shape == (0, 64) and c_next.shape == (0, 64)
          and convlstm_fused.launches == before)
    emit({"phase": "kernel", "kernel": "gate_update", "case": "zero_rows",
          "launched": convlstm_fused.launches - before, "ok": ok})
    if not ok:
        raise AssertionError("gate_update: zero rows")
    return worst


def _k1_bwd_errors(args):
    gates = args[0]
    dg_k, dc_k = convlstm_fused.gate_update_bwd(*args)
    dg_p, dc_p = convlstm_fused.gate_update_bwd_plain(*args)
    torch.cuda.synchronize()
    dgk, dgp = dg_k.float(), dg_p.float()
    if gates.dtype == torch.bfloat16:
        dg_ok = bool(((dgk - dgp).abs() <= 2 ** -7 * dgp.abs() + 1e-5).all())
    else:
        dg_ok = bool(((dgk - dgp).abs() <= 1e-5 * (1 + dgp.abs())).all())
    dc_rel = ((dc_k - dc_p).abs() / (1 + dc_p.abs())).max().item()
    err = max((dgk - dgp).abs().max().item(), (dc_k - dc_p).abs().max().item())
    return dg_ok and dc_rel <= 1e-5, err, dc_rel


def check_k1_bwd(gen, levels=K1_TRAIN_LEVELS, batch=TB, path=None):
    """K1 backward at a training path's levels (the custom model's three by
    default), bf16 (timed: the path's dtype) and f32, and once without
    dc_out (the last step's)."""
    total = _total()
    for level, C, side, launches in levels:
        rows = batch * side * side
        for dtype in (torch.bfloat16, torch.float32):
            def make():
                r = lambda *s: torch.randn(*s, device=DEV,   # noqa: E731
                                           generator=gen)
                return ((r(rows, 4 * C) * 2).to(dtype), r(rows, C),
                        r(rows, C).to(dtype), r(rows, C))

            args = make()
            ok, err, dc_rel = _k1_bwd_errors(args)
            line = {"phase": "kernel", "kernel": "gate_update_bwd",
                    "level": level, **({"path": path} if path else {}),
                    "rows": rows, "C": C,
                    "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                    "dc_rel_err": dc_rel, "ok": ok}
            if level == "bottleneck" and dtype == torch.bfloat16:
                ok_none, _, _ = _k1_bwd_errors(args[:3] + (None,))
                line["ok_without_dc_out"] = ok_none
                ok = ok and ok_none
            if dtype == torch.bfloat16:
                nbytes = rows * C * (2 * 4 * 2 + 4 + 2 + 4 + 4)
                sets = copies(make, nbytes)
                line["ms"] = device_ms(convlstm_fused.gate_update_bwd, sets)
                line["plain_ms"] = device_ms(
                    convlstm_fused.gate_update_bwd_plain, sets)
                line["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                line["launches_per_step"] = launches
                for k in ("ms", "plain_ms", "bound_ms"):
                    total[k] += line[k] * launches
            emit(line)
            if not ok:
                raise AssertionError(f"gate_update_bwd disagrees: {line}")
            total["max_abs_err"] = max(total["max_abs_err"], err)
    return total


def k2_library(x, w, b, inv, shift):
    """The same function from library calls: normalize+ReLU, cuDNN's
    conv, two reductions (a yardstick; the port never calls it)."""
    z = torch.relu(x * inv.to(x.dtype) + shift.to(x.dtype)) \
        if inv is not None else x
    y = F.conv2d(z.permute(0, 3, 1, 2), w, b.to(x.dtype), padding=1
                 ).permute(0, 2, 3, 1)
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def _k2_inputs(gen, n, side, cin, cout, prologue, dtype,
               positive_shift=False):
    def rand(*shape, normal=True):
        f = torch.randn if normal else torch.rand
        return f(*shape, device=DEV, generator=gen)

    x = rand(n, side, side, cin).to(dtype)
    w = (rand(cout, cin, 3, 3) / (3 * cin ** 0.5)).to(dtype)
    b = rand(cout) * 0.1
    inv = rand(cin, normal=False) + 0.5 if prologue else None
    shift = None
    if prologue:     # about half the channels shifted up, or all of them
        shift = rand(cin, normal=False) * 0.3 + 0.05 if positive_shift \
            else rand(cin) * 0.3
    return x, w, b, inv, shift


def _k2_errors(args, f32: bool):
    """Kernel against plain with K2_TOL (K2_F32_TOL); NaNs must sit where
    the plain version has them, and the finite values agree."""
    y, s, q = doubleconv_fused.fused_conv3x3(*args)
    yp, sp, qp = doubleconv_fused.fused_conv3x3_plain(*args)
    torch.cuda.synchronize()
    nan = torch.isnan(yp)
    same_nan = torch.equal(torch.isnan(y), nan)
    yk, yf = y.float()[~nan], yp.float()[~nan]
    d = (yk - yf).abs()
    scale = yf.abs().max().item()
    if f32:
        ok = d.max().item() <= 1e-4 * scale
    else:
        ok = bool((d <= 2 ** -7 * yf.abs() + 1e-3 * scale).all())
    if nan.any():   # the sums are NaN in both
        s_rel = q_rel = 0.0
        ok = ok and bool(torch.isnan(s).all() and torch.isnan(sp).all())
    else:
        s_rel = ((s - sp).abs().max() / yp.float().abs().sum(dim=(0, 1, 2))
                 .max()).item()
        q_rel = ((q - qp).abs().max() / qp.max()).item()
    ok = ok and same_nan and s_rel <= 1e-3 and q_rel <= 1e-3
    return ok, d.max().item(), scale, s_rel, q_rel


def _k2_plan(n, side, cin, cout, dtype):
    p = doubleconv_fused.plan(n, side, side, cin, cout, dtype)
    return p.route, {"tile": [p.bm, p.bn, p.bk], "stages": p.stages,
                     "splits": p.splits, "blocks": p.blocks,
                     "workspace_bytes": p.workspace_bytes}


def _k2_check_line(gen, n, side, cin, cout, pro, dtype=torch.bfloat16,
                   **inputs):
    """One shape checked, as its line with the route and plan; on the wgmma
    route y must be the same bits in a second run (its K order is fixed)."""
    args = _k2_inputs(gen, n, side, cin, cout, pro, dtype, **inputs)
    ok, err, scale, s_rel, q_rel = _k2_errors(args, f32=dtype != torch.bfloat16)
    route, plan = _k2_plan(n, side, cin, cout, dtype)
    line = {"phase": "kernel", "kernel": "conv3x3_fused",
            "shape": [n, side, side, cin, cout], "prologue": pro,
            "dtype": str(dtype).split(".")[-1], "route": route, "plan": plan,
            "y_abs_err": err, "y_scale": scale, "sum_rel_err": s_rel,
            "sumsq_rel_err": q_rel}
    first = doubleconv_fused.fused_conv3x3(*args)
    again = doubleconv_fused.fused_conv3x3(*args)
    line["bit_equal_rerun"] = all(_bitequal_nan(a, b)
                                  for a, b in zip(first, again))
    ok = ok and line["bit_equal_rerun"]
    line["ok"] = ok
    return line


def _bitequal_nan(a, b) -> bool:
    """The same bits, NaNs included."""
    return torch.equal(a.view(torch.int16 if a.element_size() == 2
                              else torch.int32),
                       b.view(torch.int16 if b.element_size() == 2
                              else torch.int32))


def _k2_time(line, gen, n, side, cin, cout, pro):
    """Device times of the kernel, the plain version and the library chain,
    the bound, and the shares."""
    m = n * side * side
    nbytes = 2 * (m * cin + 9 * cin * cout + m * cout) \
        + 4 * (cout + 2 * cin + 2 * cout)
    ops_ms = 2 * m * 9 * cin * cout / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    sets = copies(lambda: _k2_inputs(gen, n, side, cin, cout, pro,
                                     torch.bfloat16), nbytes)
    line["ms"] = device_ms(doubleconv_fused.fused_conv3x3, sets)
    line["plain_ms"] = device_ms(doubleconv_fused.fused_conv3x3_plain, sets)
    line["library_ms"] = device_ms(k2_library, sets)
    line["bound_ms"] = max(ops_ms, bytes_ms)
    line["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    line["tflops"] = 2 * m * 9 * cin * cout / line["ms"] / 1e9
    line["pct_of_bound"] = 100 * line["bound_ms"] / line["ms"]
    line["vs_library"] = line["ms"] / line["library_ms"]
    return ops_ms, bytes_ms


def check_k2(gen, convs, n, per, serving: bool):
    """K2 at every shape of a pass of ``n`` images, bf16, timed; y the same
    bits in a rerun. Serving also checks the other prologue setting at each
    shape and the f32 route."""
    total = dict(_total(), library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    for side, cin, cout, prologue, launches in convs:
        for pro in (prologue, not prologue) if serving else (prologue,):
            line = _k2_check_line(gen, n, side, cin, cout, pro)
            if pro != prologue:
                emit(line)
                if not line["ok"]:
                    raise AssertionError(f"conv3x3_fused disagrees: {line}")
                continue
            ops_ms, bytes_ms = _k2_time(line, gen, n, side, cin, cout, pro)
            line[f"launches_per_{per}"] = launches
            emit(line)
            if not line["ok"]:
                raise AssertionError(f"conv3x3_fused disagrees: {line}")
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                total[k] += line[k] * launches
            total["ops_ms"] += ops_ms * launches
            total["bytes_ms"] += bytes_ms * launches
            total["max_abs_err"] = max(total["max_abs_err"], line["y_abs_err"])
    if not serving:
        return total
    # the f32 route (FP32 policy) at the widest and the largest map
    for side, cin, cout in ((HW // 16, 16 * BASE, 16 * BASE),
                            (HW, BASE, BASE)):
        line = _k2_check_line(gen, n, side, cin, cout, True, torch.float32)
        emit(line)
        if not line["ok"] or line["route"] != "generic":
            raise AssertionError(f"conv3x3_fused (f32) disagrees: {line}")
    return total


def check_k2_edges(gen):
    """K2 where its design is most likely to break: every shape of the
    B=1, T=1 request (n = 1: M of 64 pixels at 8x8, K split far), timed;
    16 -> 16 and 16 -> 32 channels (the overfit gate's base_ch 16); pixel
    counts that are no multiple of any tile (300, 100, 720); every shift
    > 0, so that relu(0 * inv + shift) > 0 where the halo must be 0; a NaN
    in x, which must reach y where the plain version has it; an empty
    batch, whose sums must come back 0. Every case on the wgmma route, y
    the same bits in a rerun. Returns the B=1, T=1 request's totals."""
    total = dict(_total(), library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    cases = [dict(n=1, side=side, cin=cin, cout=cout, pro=pro, launches=k)
             for side, cin, cout, pro, k in K2_CONVS]
    cases += [dict(n=B * 10, side=HW // 2, cin=16, cout=16, pro=True),
              dict(n=B * 10, side=HW // 4, cin=16, cout=32, pro=False),
              dict(n=3, side=10, cin=64, cout=64, pro=True),
              dict(n=1, side=10, cin=512, cout=256, pro=False),
              dict(n=5, side=12, cin=32, cout=64, pro=True),
              dict(n=B, side=32, cin=128, cout=128, pro=True,
                   positive_shift=True),
              dict(n=B * T, side=HW, cin=BASE, cout=BASE, pro=True,
                   positive_shift=True),
              dict(n=2, side=8, cin=512, cout=512, pro=True,
                   positive_shift=True)]
    for c in cases:
        line = _k2_check_line(gen, c["n"], c["side"], c["cin"], c["cout"],
                              c["pro"], positive_shift=c.get("positive_shift",
                                                             False))
        line["case"] = ("b1t1" if "launches" in c else "positive_shift"
                        if c.get("positive_shift") else "edge")
        ok = line["ok"] and line["route"] == "wgmma"
        if "launches" in c:
            ops_ms, bytes_ms = _k2_time(line, gen, c["n"], c["side"],
                                        c["cin"], c["cout"], c["pro"])
            line["launches_per_request"] = c["launches"]
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                total[k] += line[k] * c["launches"]
            total["ops_ms"] += ops_ms * c["launches"]
            total["bytes_ms"] += bytes_ms * c["launches"]
            total["max_abs_err"] = max(total["max_abs_err"], line["y_abs_err"])
        emit(line)
        if not ok:
            raise AssertionError(f"conv3x3_fused disagrees: {line}")
    # a NaN in x reaches y (the prologue's ReLU keeps it), with and without
    # the prologue, on an unsplit and a split plan
    for n, side, cin, cout, pro in ((B * T, HW // 4, 2 * BASE, 2 * BASE, True),
                                    (B * T, HW // 16, 8 * BASE, 16 * BASE,
                                     False)):
        x, w, b, inv, shift = _k2_inputs(gen, n, side, cin, cout, pro,
                                         torch.bfloat16)
        x[1, side // 2, 0, cin // 3] = float("nan")
        ok, err, scale, _, _ = _k2_errors((x, w, b, inv, shift), f32=False)
        y = doubleconv_fused.fused_conv3x3(x, w, b, inv, shift)[0]
        nan_pixels = int(torch.isnan(y).any(dim=-1).sum())
        route, plan = _k2_plan(n, side, cin, cout, torch.bfloat16)
        line = {"phase": "kernel", "kernel": "conv3x3_fused",
                "case": "nan_in_x", "shape": [n, side, side, cin, cout],
                "prologue": pro, "route": route, "plan": plan,
                "nan_pixels": nan_pixels, "y_abs_err": err, "y_scale": scale}
        # the 3x3 neighbourhood of (side // 2, 0) inside the image
        h = side // 2
        reach = (min(side, h + 2) - max(0, h - 1)) * min(side, 2)
        line["ok"] = ok and nan_pixels == reach and route == "wgmma"
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"conv3x3_fused loses a NaN: {line}")
    # an empty batch: y empty and the sums 0, which the wgmma route's prep
    # kernel writes into its torch.empty sums (freed NaN blocks of their
    # size first, so that stale memory would show)
    for cin, cout, pro in ((BASE, BASE, True), (8 * BASE, 8 * BASE, False)):
        args = _k2_inputs(gen, 0, HW // 16, cin, cout, pro, torch.bfloat16)
        stale = [torch.full((cout,), float("nan"), device=DEV)
                 for _ in range(4)]
        del stale
        y, s, q = doubleconv_fused.fused_conv3x3(*args)
        torch.cuda.synchronize()
        route, plan = _k2_plan(0, HW // 16, cin, cout, torch.bfloat16)
        line = {"phase": "kernel", "kernel": "conv3x3_fused",
                "case": "empty_batch", "shape": [0, HW // 16, HW // 16, cin,
                                                 cout],
                "prologue": pro, "route": route, "plan": plan,
                "y_shape": list(y.shape),
                "sums_zero": bool((s == 0).all() and (q == 0).all())}
        line["ok"] = (route == "wgmma" and line["sums_zero"]
                      and line["y_shape"] == line["shape"][:3] + [cout])
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"conv3x3_fused on an empty batch: {line}")
    return total


def _mc_k_inputs(gen, groups: int):
    """Directions, majorants (a tenth of them 0: empty super-voxels),
    uniforms and per-group seeds for ``groups`` x 65,536 lanes."""
    n = groups * MC_LANES
    d = torch.randn(n, 3, device=DEV, generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    m = torch.rand(n, device=DEV, generator=gen) * 0.2
    m = torch.where(torch.rand(n, device=DEV, generator=gen) < 0.1, 0.0, m)
    u = torch.rand(4, n, device=DEV, generator=gen)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (groups,), device=DEV,
                          generator=gen, dtype=torch.int64).to(torch.int32)
    return d, m, u, seeds


def _mc_k_errors(kernel, plain):
    """(ok, max abs err, the errors) of a kernel's (t, u_acc, new_d)
    against its plain version's, with MC_K_TOL."""
    (t, ua, nd), (tp, uap, ndp) = kernel, plain
    torch.cuda.synchronize()
    t_rel = float(((t - tp).abs() / tp.abs().clamp_min(1e-30)).max())
    dd = (nd - ndp).abs()
    big = float((dd > 1e-5).any(dim=1).float().mean())
    norm = float((nd.norm(dim=1) - 1).abs().max())
    ok = (torch.equal(ua, uap) and t_rel <= 1e-6 and big <= 1e-4
          and float(dd.max()) <= 1e-3 and norm <= 1e-5)
    err = max(float((t - tp).abs().max()), float(dd.max()))
    return ok, err, {"t_rel": t_rel, "new_d_abs": float(dd.max()),
                     "new_d_lanes_beyond_1e-5": big, "norm": norm}


def check_mc_kernels(gen):
    """K4 and K5 against their plain versions, g 0.85 and 0.0, at one view
    (65,536 lanes) and at the MC main path's launch (16 rounds of a view),
    timed at g 0.85 with inputs rotated past L2. K4's plain version draws
    the same Philox words, so the two are compared value for value."""
    out = {}
    for g in (0.85, 0.0):
        for groups in (1, MC_SPP):
            args = _mc_k_inputs(gen, groups)
            d, m, u, seeds = args
            ok5, err5, e5 = _mc_k_errors(
                mc_sampler.mc_sample_flights_with_uniforms(u, d, m, g),
                mc_sampler.sample_flights_with_uniforms_plain(u, d, m, g))
            ok4, err4, e4 = _mc_k_errors(
                mc_sampler.mc_sample_flights(seeds, 7, d, m, g),
                mc_sampler.sample_flights_plain(seeds, 7, d, m, g))
            n = groups * MC_LANES
            line = {"phase": "kernel", "kernel": "mc_sample_flights (K4), "
                    "mc_sample_flights_uniforms (K5)", "g": g, "lanes": n,
                    "groups": groups, "k4": e4, "k5": e5, "ok": ok4 and ok5}
            if g == 0.85:
                sets = copies(lambda: _mc_k_inputs(gen, groups), 52 * n)

                def k4(d, m, u, seeds, fn=mc_sampler.mc_sample_flights):
                    return fn(seeds, 7, d, m, g)

                def k5(d, m, u, seeds,
                       fn=mc_sampler.mc_sample_flights_with_uniforms):
                    return fn(u, d, m, g)

                for name, fn, fp, nbytes, err in (
                        ("mc_sample_flights", k4, functools.partial(
                            k4, fn=mc_sampler.sample_flights_plain),
                         36 * n, err4),
                        ("mc_sample_flights_uniforms", k5, functools.partial(
                            k5,
                            fn=mc_sampler.sample_flights_with_uniforms_plain),
                         52 * n, err5)):
                    t = {"ms": device_ms(fn, sets),
                         "plain_ms": device_ms(fp, sets),
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "max_abs_err": err}
                    line[name] = t
                    out[name, groups] = t
            emit(line)
            if not line["ok"]:
                raise AssertionError(f"mc sampler kernels disagree: {line}")
            for name, err in (("mc_sample_flights", err4),
                              ("mc_sample_flights_uniforms", err5)):
                t = out[name, groups]
                t["max_abs_err"] = max(t["max_abs_err"], err)
    return out


def _k6_errors(x):
    """(ok, the means' max abs err, errors) of K6 against its plain version
    with K6_TOL; two kernel runs must give the same bits."""
    s, q = channel_stats.channel_sum_sumsq(x)
    s2, q2 = channel_stats.channel_sum_sumsq(x)
    sp, qp = channel_stats.channel_sum_sumsq_plain(x)
    torch.cuda.synchronize()
    dims = tuple(range(x.dim() - 1))
    abs_sum = x.float().abs().sum(dims).clamp_min(1e-30)
    rows = x.numel() // x.shape[-1]
    e = {"sum_rel_abs": float(((s - sp).abs() / abs_sum).max()),
         "sumsq_rel": float(((q - qp).abs() / qp.clamp_min(1e-30)).max()),
         "bit_equal_runs": torch.equal(s, s2) and torch.equal(q, q2)}
    err = max(float((s - sp).abs().max()), float((q - qp).abs().max())) / rows
    ok = e["bit_equal_runs"] and e["sum_rel_abs"] <= 1e-5 \
        and e["sumsq_rel"] <= 1e-5 and err <= 1e-5
    return ok, err, e


def k6_library(x):
    """One PyTorch call for the same statistics: mean and inverse std per
    channel of the channels-last view (a yardstick; the port never calls
    it)."""
    return torch.batch_norm_stats(x.permute(0, 3, 1, 2), 1e-5)


def check_k6(gen):
    """K6 at the BN probe's activation (bf16, timed), and at ragged row
    counts and channel counts in bf16 and f32."""
    shape = bn_kernel_proto.SHAPE
    out = {}
    for shp, dtype in ((shape, torch.bfloat16), ((999, 37, 32), torch.bfloat16),
                       ((1001, 3, 24), torch.float32),
                       ((3, 5, 7, 33), torch.float32)):
        def make():
            return (torch.randn(*shp, device=DEV, generator=gen) * 0.5).to(
                dtype)

        x = make()
        ok, err, e = _k6_errors(x)
        line = {"phase": "kernel", "kernel": "channel_sum_sumsq",
                "shape": list(shp), "dtype": str(dtype).split(".")[-1],
                "rows": x.numel() // shp[-1], "means_abs_err": err, **e,
                "ok": ok}
        if shp == shape:
            nbytes = x.numel() * x.element_size() + 2 * 4 * shp[-1]
            sets = [(t,) for t in copies(make, nbytes)]
            del x
            line.update(
                ms=device_ms(channel_stats.channel_sum_sumsq, sets),
                plain_ms=device_ms(channel_stats.channel_sum_sumsq_plain,
                                   sets),
                library_ms=device_ms(k6_library, sets),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                max_abs_err=err)
            del sets
            out = line
        emit(line)
        if not ok:
            raise AssertionError(f"channel_sum_sumsq disagrees: {line}")
    torch.cuda.empty_cache()
    return out


def _launch_floor_ms() -> float:
    """Device time of one empty kernel launched back to back."""
    return device_ms(lambda: torch.cuda._sleep(0), [()], n=200)


def _latency_floor_ms(reps: int) -> float:
    """Device time of the one-block chase beside K7 (``reps`` dependent
    shared loads a lane), launched back to back: the least time a chain of
    ``reps`` links takes, launch included."""
    out = torch.zeros(32, dtype=torch.int32, device=DEV)
    ms = device_ms(lambda: chained_gather.latency_floor(reps, out), [()],
                   n=200)
    if out.tolist() != list(range(32)):
        raise AssertionError("chained_gather_latency_floor: wrong chase")
    return ms


def _k7_plan(shape, axis):
    p = chained_gather.plan(*shape, axis)
    return {"plan": {"lines": p.lines, "splits": p.splits, "chunk": p.chunk,
                     "threads": p.threads, "pair": p.pair,
                     "smem_bytes": p.smem_bytes, "blocks": p.blocks}}


def check_k7(gen):
    """K7 at the gather probe's five shapes, reps 64 (timed) and 1, on
    negative, out-of-range values (the floor modulo), where the last tile
    holds fewer lines than the plan's full tile (in both layouts), and at
    the longest line the wrapper takes along each axis: bit-equal."""
    variants = []
    floor_ms = _launch_floor_ms()
    latency_ms = _latency_floor_ms(probe_gather.REPS)
    for name, shape, axis in probe_gather.VARIANTS:
        x_np, idx_np = probe_gather.variant_inputs(shape, axis)
        x = torch.from_numpy(x_np).to(DEV)
        idx = torch.from_numpy(idx_np).to(DEV)
        equal = {reps: torch.equal(
            chained_gather.chained_gather(x, idx, axis, reps),
            chained_gather.chained_gather_plain(x, idx, axis, reps))
            for reps in (probe_gather.REPS, 1)}
        reps = probe_gather.REPS
        elems = shape[0] * shape[1]
        nbytes = 12 * elems
        ops_ms = reps * elems / F32_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3

        def make():
            return (torch.rand(*shape, device=DEV, generator=gen),
                    torch.randint(0, shape[axis], shape, device=DEV,
                                  generator=gen, dtype=torch.int32))

        sets = copies(make, nbytes)
        line = {"phase": "kernel", "kernel": "chained_gather",
                "variant": name, "shape": list(shape), "axis": axis,
                "reps": reps, "bit_equal": {str(k): v for k, v in
                                            equal.items()},
                "ms": device_ms(lambda a, i: chained_gather.chained_gather(
                    a, i, axis, reps), sets),
                "plain_ms": device_ms(
                    lambda a, i: chained_gather.chained_gather_plain(
                        a, i, axis, reps), sets),
                "library_ms": device_ms(
                    lambda a, i: torch.gather(a, axis, i),
                    [(a, i.long()) for a, i in sets]),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "launch_floor_ms": floor_ms, "latency_floor_ms": latency_ms,
                **_k7_plan(shape, axis), "max_abs_err": 0.0,
                "ok": all(equal.values())}
        emit(line)
        variants.append(line)
        if not line["ok"]:
            raise AssertionError(f"chained_gather disagrees: {line}")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((512, 128)) * 300).astype(
        np.float32)).to(DEV)
    idx = torch.from_numpy(rng.integers(0, 128, (512, 128)).astype(
        np.int32)).to(DEV)
    negative = {axis: torch.equal(
        chained_gather.chained_gather(x, idx, axis, probe_gather.REPS),
        chained_gather.chained_gather_plain(x, idx, axis, probe_gather.REPS))
        for axis in (0, 1)}
    emit({"phase": "kernel", "kernel": "chained_gather",
          "variant": "floor modulo: values N(0, 300^2) at (512,128)",
          "bit_equal_by_axis": negative, "ok": all(negative.values())})
    if not all(negative.values()):
        raise AssertionError("chained_gather: floor modulo case disagrees")
    # a last tile of 1 line (of 16) along axis 1 and of 4 along axis 0: most
    # of its blocks have no chain
    for shape, axis in (((17, 128), 1), ((512, 20), 0)):
        n = shape[axis]
        x = torch.rand(*shape, device=DEV, generator=gen) * n
        idx = torch.randint(0, n, shape, device=DEV, generator=gen,
                            dtype=torch.int32)
        equal = {}
        for pair in (True, False):
            p = chained_gather.plan(*shape, axis, pair)
            for reps in (probe_gather.REPS, 1):
                equal[f"pair={pair} reps={reps}"] = torch.equal(
                    chained_gather._launch(x, idx, axis, reps, p),
                    chained_gather.chained_gather_plain(x, idx, axis, reps))
        line = {"phase": "kernel", "kernel": "chained_gather",
                "variant": "short last tile", "shape": list(shape),
                "axis": axis, **_k7_plan(shape, axis), "bit_equal": equal,
                "ok": all(equal.values())}
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"chained_gather disagrees: {line}")
    # the longest line the wrapper takes: 4 (n + 1) bytes within a block's
    # shared memory (x through L1, next alone in shared memory)
    longest = chained_gather._SMEM_BYTES // 4 - 1
    for shape, axis in (((4, longest), 1), ((longest, 16), 0)):
        n = shape[axis]
        x = torch.rand(*shape, device=DEV, generator=gen) * n
        idx = torch.randint(0, n, shape, device=DEV, generator=gen,
                            dtype=torch.int32)
        equal = {str(reps): torch.equal(
            chained_gather.chained_gather(x, idx, axis, reps),
            chained_gather.chained_gather_plain(x, idx, axis, reps))
            for reps in (probe_gather.REPS, 1)}
        line = {"phase": "kernel", "kernel": "chained_gather",
                "variant": "longest line", "shape": list(shape),
                "axis": axis,
                **_k7_plan(shape, axis), "bit_equal": equal,
                "ms": device_ms(lambda a, i: chained_gather.chained_gather(
                    a, i, axis, probe_gather.REPS), [(x, idx)] * 2),
                "ok": all(equal.values())}
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"chained_gather disagrees: {line}")
    return variants


# ---------------------------------------------------------------------------
# 2b. K8, the int8 implicit-GEMM conv
# ---------------------------------------------------------------------------

def k8_custom_convs(base, hw, b, t):
    """Every int8 conv of one custom forward of b sequences of t frames, as
    (kind, N, H, W, cin, cout, k, stride, pad, launches): the encoder and
    decoder batched over b*t frames, the three ConvLSTM gate convs once a
    step over b; kind "up2" is the 2x2 stride-2 transposed conv."""
    n = b * t
    ch = [base << i for i in range(5)]
    side = [hw >> i for i in range(5)]
    convs = [("conv", n, side[0], side[0], 2, ch[0], 3, 1, 1),
             ("conv", n, side[0], side[0], ch[0], ch[0], 3, 1, 1)]
    for i in range(1, 5):
        convs += [("conv", n, side[i], side[i], ch[i - 1], ch[i], 3, 1, 1),
                  ("conv", n, side[i], side[i], ch[i], ch[i], 3, 1, 1)]
    for lvl in (4, 3, 2):                    # temporal, skip3, skip2
        convs += [("conv", b, side[lvl], side[lvl], 2 * ch[lvl],
                   4 * ch[lvl], 3, 1, 1)] * t
    for i in range(3, -1, -1):               # up3..up0
        convs += [("up2", n, side[i + 1], side[i + 1], ch[i + 1], ch[i], 2,
                   2, 0),
                  ("conv", n, side[i], side[i], ch[i + 1], ch[i], 3, 1, 1),
                  ("conv", n, side[i], side[i], ch[i], ch[i], 3, 1, 1)]
    convs.append(("conv", n, side[0], side[0], ch[0], 1, 1, 1, 0))  # outc
    return [(*c, k) for c, k in collections.Counter(convs).items()]


def k8_resnet_convs(hw, b, t, layers):
    """The same for one ResNet18-UNet forward: the 7x7 stride-2 stem, the
    encoder's 3x3 (stride 2 at a stage's first block) and 1x1 stride-2
    downsample convs, five ConvLSTMs of ``layers`` cells, the decoder's
    DoubleConvs and the 3x3 head."""
    n = b * t
    convs = [("conv", n, hw, hw, 2, 64, 7, 2, 3)]
    s, cin = hw // 4, 64
    for cout, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        for blk in range(2):
            st, ci = (stride, cin) if blk == 0 else (1, cout)
            convs.append(("conv", n, s, s, ci, cout, 3, st, 1))
            if st != 1 or ci != cout:
                convs.append(("conv", n, s, s, ci, cout, 1, st, 0))
            s //= st
            convs.append(("conv", n, s, s, cout, cout, 3, 1, 1))
        cin = cout
    for C, d in ((512, 32), (256, 16), (128, 8), (64, 4), (64, 2)):
        convs += [("conv", b, hw // d, hw // d, 2 * C, 4 * C, 3, 1, 1)] * (
            layers * t)
    for i, (ci, cs, co) in enumerate(zip((512, 256, 128, 64, 32),
                                         (256, 128, 64, 64, 0),
                                         (256, 128, 64, 32, 16))):
        side = hw // 16 << i
        convs += [("conv", n, side, side, ci + cs, co, 3, 1, 1),
                  ("conv", n, side, side, co, co, 3, 1, 1)]
    convs.append(("conv", n, hw, hw, 16, 1, 3, 1, 1))            # head
    return [(*c, k) for c, k in collections.Counter(convs).items()]


INT8_OPS_PER_S = 1979e12                 # dense int8 tensor cores, same
IB, IT = 8, 12          # the int8 path: scripts/perf/bench_int8.py:30-35
K8_CUSTOM = k8_custom_convs(BASE, HW, IB, IT)
K8_RESNET = k8_resnet_convs(HW, B, T, 2)
K8_PER_FORWARD = sum(c[-1] for c in K8_CUSTOM)
K8_RESNET_PER_REQUEST = sum(c[-1] for c in K8_RESNET)
# where the kernel's routes, loaders and edges are not those of the main
# paths: the first design's loaders (Cin 2 and 20 gathered, Cout 1, 12 and
# 30 on the vec loader), and on the wgmma route Cin 16 and 48 (the last K
# chunk half zero), pixel counts not a multiple of 128, column counts not a
# multiple of the tile (72, 520, 96 and 32 transposed, 8, 24), K of one
# chunk, stride 2 on an odd input, split K (Cin 48, 256 -> 520, 256 -> 64)
# and the halo mode of a float x on odd maps whose tiles straddle images
K8_RAGGED = [("conv", 2, 17, 15, 2, 64, 3, 1, 1, 0),    # Cin 2, odd H, W
             ("conv", 2, 17, 15, 20, 40, 3, 1, 1, 0),   # Cin 20: gather
             ("conv", 2, 17, 15, 48, 72, 3, 1, 1, 0),   # Cin 48: split K
             ("conv", 3, 15, 13, 64, 128, 1, 2, 0, 0),  # stride 2, odd in
             ("conv", 2, 33, 31, 2, 64, 7, 2, 3, 0),    # stem, odd in
             ("conv", 2, 16, 16, 2, 1, 7, 1, 3, 0),     # attention, Cout 1
             ("up2", 1, 5, 7, 48, 24, 2, 2, 0, 0),      # odd transposed
             ("conv", 2, 9, 11, 16, 16, 3, 1, 1, 0),    # Cin 16: K 144
             ("conv", 1, 5, 5, 256, 520, 3, 1, 1, 0),   # M 25, split K
             ("conv", 3, 7, 9, 32, 8, 1, 1, 0, 0),      # K 32, 8 columns
             ("up2", 2, 3, 5, 64, 8, 2, 2, 0, 0),       # 32 columns
             ("conv", 2, 12, 12, 16, 12, 3, 1, 1, 0),   # Cout 12: vec
             ("conv", 2, 9, 9, 64, 30, 3, 1, 1, 0),     # vec, 64-byte steps
             ("conv", 3, 13, 11, 32, 24, 3, 1, 1, 0),   # halo across images
             ("conv", 1, 6, 6, 256, 64, 3, 1, 1, 0)]    # halo, split K
K8_TOL = ("bit-equal to the plain version in f32 and bf16, both entries (an "
          "int8 x; a bf16 or f32 x quantized with a static or a dynamic "
          "scale): both quantize as clamp(round-half-even(x / x_s)) after "
          "one IEEE division, round the same exact int32 to f32 and apply "
          "the scale and the bias as two separately rounded f32 operations")
K8_STATIC_XS = 2.0 ** -7  # a power of two: x / x_s exact, so bf16 inputs
#                           fall on rounding midpoints, and |x| > 127 x_s
#                           (about a third of N(0, 1)) is clamped
INT8_PTQ_BOUND = 0.06     # int8 against bf16, relative L2, on the seeded
#                           model with its BatchNorm statistics at init:
#                           the JAX test's bound and condition (a fresh
#                           init, tests/test_quant.py:98). With calibrated
#                           BatchNorm (unit-scale activations through 26
#                           convs) a random model amplifies the rounding,
#                           the JAX model as much as the port's
#                           (tests/test_torch_quant.py holds the two
#                           packages' PTQ noise to each other there), so
#                           that number is reported, not bounded
INT8_EVAL_SANITY = 2.0    # evaluate --int8: at most 2x the bf16 MAE, a
#                           gross-fault bound (a wrong scale or layout
#                           moves the MAE by far more). BASELINE.md's 10%
#                           held for the JAX drive's checkpoint; how far
#                           int8 moves a model's MAE is the checkpoint's
#                           property (the port's int8 is the JAX package's
#                           function, tests/test_torch_quant.py), and this
#                           phase's checkpoint changes from run to run (the
#                           training run is not bit-reproducible), so the
#                           ratio is reported beside it, and the card's
#                           int8 path is held exactly by K8 against its
#                           plain version through evaluate_model
INT8_PLAIN_TOL = 1e-5     # int8 forward, K8 against its plain version, f32


def _k8_pads(pad):
    return ((pad, pad), (pad, pad))


def k8_plan(kind, n, h, w, cin, cout, k, stride, pad,
            x_dtype=torch.bfloat16):
    """K8's plan of one conv of a pass (``conv_int8.conv_plan``)."""
    if kind == "up2":
        return conv_int8.conv_plan((n, h, w, cin), (cin, cout, 2, 2), 2,
                                   _k8_pads(0), x_dtype, transposed=True)
    return conv_int8.conv_plan((n, h, w, cin), (cout, cin, k, k), stride,
                               _k8_pads(pad), x_dtype)


def k8_route_counts(convs, x_dtype=torch.bfloat16):
    """K8's launches of one pass by route, from the planner."""
    out = dict.fromkeys(conv_int8.ROUTES, 0)
    for c in convs:
        out[k8_plan(*c[:-1], x_dtype=x_dtype).route] += c[-1]
    return out


def _k8_args(gen, kind, n, h, w, cin, cout, k, bias=True):
    """(x float32 N(0, 1), x_q int8, w_q, w_s, x_s, bias) on the card."""
    x = torch.randn((n, h, w, cin), generator=gen, device=DEV)
    xq = torch.randint(-127, 128, (n, h, w, cin), generator=gen, device=DEV,
                       dtype=torch.int8)
    if kind == "up2":
        wq = torch.randint(-127, 128, (cin, cout, 2, 2), generator=gen,
                           device=DEV, dtype=torch.int8)
    else:
        wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                           device=DEV, dtype=torch.int8).contiguous(
            memory_format=torch.channels_last)
    ws = torch.rand(cout, generator=gen, device=DEV) * 1e-3 + 1e-5
    xs = torch.rand((), generator=gen, device=DEV) * 0.05 + 1e-3
    b = torch.randn(cout, generator=gen, device=DEV) if bias else None
    return x, xq, wq, ws, xs, b


def _k8_call(kind, stride, pad, dtype, quant=False):
    """K8 as the wrapper a conv of ``kind`` calls: fn(x, w_q, w_s, x_s, b)
    with an int8 x, or with ``quant`` a float x (x_s None: dynamic)."""
    if kind == "up2":
        fn = (conv_int8.conv_transpose_int8_quant if quant
              else conv_int8.conv_transpose_int8)
        return lambda x, wq, ws, xs, b: fn(x, wq, ws, xs, b, 2, dtype)
    fn = conv_int8.conv_int8_quant if quant else conv_int8.conv_int8
    return lambda x, wq, ws, xs, b: fn(x, wq, ws, xs, b, stride,
                                       _k8_pads(pad), dtype)


def _k8_gemm(kind, x_shape, cout, k, stride, pad):
    """(M, N, K) of one K8 launch: output pixels, columns and the true
    depth k*k*Cin, which the bound counts (the kernel pads K with zeros)."""
    n, h, w, cin = x_shape
    if kind == "up2":
        return n * h * w, 4 * cout, cin
    p_ = conv_int8.out_size(h, k, stride, (pad, pad))
    q_ = conv_int8.out_size(w, k, stride, (pad, pad))
    return n * p_ * q_, cout, k * k * cin


def _k8_library(kind, stride, pad):
    """cuDNN's bf16 conv at the same shape (channels-last, bias in its
    epilogue): the float conv the int8 path replaces, a reference point and
    not the same function."""
    def run(xb, wb, b):
        if kind == "up2":
            return F.conv_transpose2d(xb, wb, b, 2)
        return F.conv2d(xb, wb, b, stride, pad)
    return run


def _int_mm_ms(gen, m_, n_, k_):
    """torch._int_mm (cuBLASLt's int8 tensor-core GEMM) at (M, N, K) on an
    A already im2col'd, timed without the im2col: the GEMM alone, not the
    same function. None where its shape rules refuse the shape (M > 16, K
    and N multiples of 8)."""
    if m_ <= 16 or k_ % 8 or n_ % 8:
        return None, "refused by _int_mm's shape rules"
    def make():
        a = torch.randint(-127, 128, (m_, k_), generator=gen, device=DEV,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (n_, k_), generator=gen, device=DEV,
                          dtype=torch.int8)
        return a, b.t()
    try:
        return device_ms(torch._int_mm, copies(make, m_ * k_ + n_ * k_)), \
            None
    except RuntimeError as e:
        return None, str(e)[:120]


def _k8_equal(fn, args):
    """(bit-equal, max |difference|) of K8 and its plain version."""
    y = fn(*args)
    with conv_int8.plain_reference():
        ref = fn(*args)
    torch.cuda.synchronize()
    view = torch.int32 if y.dtype == torch.float32 else torch.int16
    err = float((y.float() - ref.float()).abs().max()) if y.numel() else 0.0
    return torch.equal(y.view(view), ref.view(view)), err


def check_k8(gen, convs, path, timed=True):
    """K8 against its plain version at each shape (bit equality): the int8
    entry in f32 and bf16, and the quantizing entry on a bf16 and an f32 x
    with a static and a dynamic scale, in f32 and bf16; where ``timed``,
    the device time of the main path's call (quantizing entry, bf16 x,
    static scale, bf16 y), of its dynamic and int8-input variants, the
    plain version's, cuDNN's bf16 conv at the shape, torch._int_mm at the
    GEMM's (M, N, K), and the bound. Returns the totals of one pass (each
    shape's numbers times its launches)."""
    tot = collections.Counter()
    worst = 0.0
    int_mm_null = 0
    for kind, n, h, w, cin, cout, k, stride, pad, per in convs:
        x, xq, wq, ws, xs, b = _k8_args(gen, kind, n, h, w, cin, cout, k)
        line = {"phase": "kernel", "kernel": "conv_int8", "path": path,
                "kind": kind, "N": n, "H": h, "W": w, "cin": cin,
                "cout": cout, "k": k, "stride": stride, "pad": pad,
                "launches_per_pass": per}
        quant = {}
        errs = []
        static = torch.tensor(K8_STATIC_XS, device=DEV)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            eq, err = _k8_equal(_k8_call(kind, stride, pad, dtype),
                                (xq, wq, ws, xs, b))
            line[f"bit_equal_{tag}"] = eq
            errs.append(err)
            for xdt, xtag in ((torch.bfloat16, "bf16"),
                              (torch.float32, "f32")):
                xin = x.to(xdt)
                for scale, stag in ((static, "static"), (None, "dynamic")):
                    eq, err = _k8_equal(
                        _k8_call(kind, stride, pad, dtype, quant=True),
                        (xin, wq, ws, scale, b))
                    quant[f"x_{xtag}_{stag}_y_{tag}"] = eq
                    errs.append(err)
        line["bit_equal_quant"] = quant
        line["max_abs_err"] = max(errs)
        worst = max(worst, line["max_abs_err"])
        line["plan"] = dataclasses.asdict(k8_plan(
            kind, n, h, w, cin, cout, k, stride, pad))
        line["plan_int8_x"] = dataclasses.asdict(k8_plan(
            kind, n, h, w, cin, cout, k, stride, pad, torch.int8))
        line["route"] = line["plan"]["route"]
        ok = (line["bit_equal_f32"] and line["bit_equal_bf16"]
              and all(quant.values()))
        del x, xq
        if timed:
            def make():
                xf, xq_, wq_, ws_, xs_, b_ = _k8_args(
                    gen, kind, n, h, w, cin, cout, k)
                # a calibrated scale: max|x| / 127 of the input itself (the
                # power-of-two scale of the checks puts a bf16 x on the
                # rounding midpoints, the quantizer's exact path)
                cal = xf.abs().amax() / torch.tensor(127.0, device=DEV)
                return xf.to(torch.bfloat16), xq_, wq_, ws_, xs_, b_, cal

            sets = copies(make, 3 * n * h * w * cin + wq.numel())
            main = _k8_call(kind, stride, pad, torch.bfloat16, quant=True)
            int8_in = _k8_call(kind, stride, pad, torch.bfloat16)
            quant_sets = [(s[0], s[2], s[3], s[6], s[5]) for s in sets]
            line["ms"] = device_ms(main, quant_sets)
            line["ms_dynamic"] = device_ms(
                main, [(s[0], s[2], s[3], None, s[5]) for s in sets])
            line["ms_int8_input"] = device_ms(
                int8_in, [(s[1], s[2], s[3], s[4], s[5]) for s in sets])
            with conv_int8.plain_reference():
                line["plain_ms"] = device_ms(main, quant_sets[:2], n=3)
            lib = _k8_library(kind, stride, pad)
            lib_sets = [(a[0].permute(0, 3, 1, 2), a[2].to(torch.bfloat16),
                         a[5].to(torch.bfloat16)) for a in sets]
            line["library_ms"] = None     # no PyTorch int8 conv
            line["cudnn_bf16_ms"] = device_ms(lib, lib_sets)
            line["cudnn_bf16"] = ("cuDNN's bf16 conv at this shape: a "
                                  "reference point (the float conv int8 "
                                  "replaces), not the same function")
            del sets, lib_sets, quant_sets
            m_, n_, k_ = _k8_gemm(kind, (n, h, w, cin), cout, k, stride,
                                  pad)
            line["int_mm_ms"], why = _int_mm_ms(gen, m_, n_, k_)
            line["int_mm"] = ("torch._int_mm at the GEMM's (M, N, K) on an "
                              "A already im2col'd: the GEMM alone, not the "
                              "same function") if why is None else why
            out_elems = m_ * n_
            wbytes = wq.numel() + 8 * cout
            ops_ms = 2 * m_ * n_ * k_ / INT8_OPS_PER_S * 1e3
            bytes_ms = (2 * n * h * w * cin + wbytes + 2 * out_elems) \
                / HBM_BYTES_PER_S * 1e3
            bytes8_ms = (n * h * w * cin + wbytes + 2 * out_elems) \
                / HBM_BYTES_PER_S * 1e3
            line.update(bound_ms=max(ops_ms, bytes_ms),
                        bound_by="operations" if ops_ms >= bytes_ms
                        else "bytes",
                        bound_ms_int8_input=max(ops_ms, bytes8_ms),
                        pct_of_bound=100 * max(ops_ms, bytes_ms)
                        / line["ms"],
                        pct_of_bound_int8_input=100 * max(ops_ms, bytes8_ms)
                        / line["ms_int8_input"],
                        tops=2 * m_ * n_ * k_ / line["ms"] / 1e9)
            for key in ("ms", "ms_dynamic", "ms_int8_input", "plain_ms",
                        "cudnn_bf16_ms", "bound_ms", "bound_ms_int8_input"):
                tot[key] += line[key] * per
            if line["int_mm_ms"] is None:
                int_mm_null += per
            else:
                tot["int_mm_ms"] += line["int_mm_ms"] * per
            tot["ops_ms"] += ops_ms * per
            tot["bytes_ms"] += bytes_ms * per
        emit(line)
        if not ok:
            raise AssertionError(f"conv_int8 differs from its plain version: "
                                 f"{line}")
    torch.cuda.empty_cache()
    return dict(tot, max_abs_err=worst, shapes=len(convs),
                launches_per_pass=sum(c[-1] for c in convs),
                int_mm_null_launches=int_mm_null,
                routes=k8_route_counts(convs))


def check_k8_offset(gen):
    """Both entries on an x whose base lies off a 16-byte boundary (a
    contiguous view one element into its storage): the byte gather, bit-
    equal to the plain version, in f32 and bf16."""
    shape = (2, 9, 7, 32)
    wq = torch.randint(-127, 128, (24, 32, 3, 3), generator=gen, device=DEV,
                       dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    ws = torch.rand(24, generator=gen, device=DEV) * 1e-3 + 1e-5
    xs = torch.rand((), generator=gen, device=DEV) * 0.05 + 1e-3
    b = torch.randn(24, generator=gen, device=DEV)
    numel = math.prod(shape)
    out = {}
    for xdt, quant in ((torch.int8, False), (torch.bfloat16, True),
                       (torch.float32, True)):
        if quant:
            base = torch.randn(numel + 1, generator=gen, device=DEV).to(xdt)
        else:
            base = torch.randint(-127, 128, (numel + 1,), generator=gen,
                                 device=DEV, dtype=xdt)
        x = base[1:].view(shape)
        before = dict(conv_int8.launches_by_route)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for scale, stag in (((xs, "x_s"),) if not quant
                                else ((xs, "static"), (None, "dynamic"))):
                eq, _ = _k8_equal(_k8_call("conv", 1, 1, dtype, quant),
                                  (x, wq, ws, scale, b))
                out[f"x_{str(xdt)[6:]}_{stag}_y_{tag}"] = eq
        out[f"gather_launches_x_{str(xdt)[6:]}"] = (
            conv_int8.launches_by_route["gather"] - before["gather"])
    emit({"phase": "kernel", "kernel": "conv_int8", "case": "offset_view",
          "shape": list(shape), "bit_equal": out})
    calls = {"int8": 2, "bfloat16": 4, "float32": 4}
    if not all(v is True for k, v in out.items() if not k.startswith(
            "gather_")) or any(out[f"gather_launches_x_{t}"] != n
                               for t, n in calls.items()):
        raise AssertionError(f"conv_int8 on an offset view: {out}")


def k8_counts():
    """``launch_counts()`` with K8's launches by route and by entry."""
    return dict(path_counts(), **{
        f"conv_int8_{route}": k
        for route, k in conv_int8.launches_by_route.items()}, **{
        f"conv_int8_{entry}_entry": k
        for entry, k in conv_int8.launches_by_entry.items()})


def k8_expect(convs):
    """The K8 part of a ``k8_counts()`` expectation for one pass of
    ``convs`` on the main path: every call on the quantizing entry, by the
    planner's routes."""
    n = sum(c[-1] for c in convs)
    return dict(conv_int8=n, conv_int8_quant_entry=n,
                conv_int8_int8_entry=0,
                **{f"conv_int8_{r}": k
                   for r, k in k8_route_counts(convs).items()})


# ---------------------------------------------------------------------------
# 3. serving
# ---------------------------------------------------------------------------

def calibrate_bn(model, x, apply=temporal_unet_apply):
    """Set every BatchNorm's running statistics to the batch statistics of
    one train-mode forward over ``x``, as training would leave them, so
    that the random model's activations keep unit scale through its depth
    (with untouched running stats they shrink layer by layer). A frozen
    encoder's BatchNorms return their running stats and stay as they are."""
    with torch.inference_mode():
        _, _, stats = apply(model, x, train=True)
    momentum = 0.1
    for path, bn in model.bn_layers().items():
        mean, var = functools.reduce(lambda t, k: t[k], path, stats)
        if mean is bn.running_mean:
            continue
        # new = (1 - m) * old + m * batch  →  batch
        with torch.no_grad():
            bn.running_mean.copy_(
                (mean - (1 - momentum) * bn.running_mean) / momentum)
            bn.running_var.copy_(
                (var - (1 - momentum) * bn.running_var) / momentum)


def _post(conn, path, body, headers=None):
    conn.request("POST", path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    if r.status != 200:
        raise AssertionError(f"POST {path}: HTTP {r.status} {data[:200]!r}")
    return r, data


def phase_serve(workdir: str):
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model_cfg = {"type": "custom", "base_ch": BASE}
    cfg, init, _, _ = build_model(model_cfg)
    model = init(torch.Generator().manual_seed(SEED), device=DEV)
    # raw frames (radiance-like, >= 0) and targets (velocity-like) for the
    # manifest; one request's worth calibrates BatchNorm
    X = (rng.gamma(2.0, 0.6, (8, T, HW, HW, 2))).astype(np.float32)
    Y = (rng.standard_normal((8, T, HW, HW, 1)) * 5).astype(np.float32)
    norm = compute_norm_stats(X, Y)
    calibrate_bn(model, normalize_x(torch.from_numpy(X[:B]).to(DEV), norm))
    ckpt = save_checkpoint(os.path.join(workdir, "model.pt"),
                           model.state_dict(), model_cfg, norm.to_dict())
    del model
    pred = StreamingPredictor(ckpt, device=DEV)
    pred.warmup(B, HW, HW, T)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pred.model.parameters())
    emit({"phase": "serve_setup", "config": cfg.to_dict(),
          "params": n_params, "checkpoint_mb": os.path.getsize(ckpt) / 2**20,
          "setup_s": time.perf_counter() - t0})

    frames = (rng.gamma(2.0, 0.6, (SESSIONS, REQUESTS_PER_SESSION, B, T, HW,
                                   HW, 2))).astype(np.float32)

    # -- the main path, with the launch counts read around it -------------
    sids = [pred.open_session(B, HW, HW) for _ in range(SESSIONS)]
    reset_launches()
    outs = []
    for r in range(REQUESTS_PER_SESSION):
        for s, sid in enumerate(sids):
            outs.append(pred.predict(sid, frames[s, r]))
    counts = path_counts()
    requests = SESSIONS * REQUESTS_PER_SESSION
    expect = on_main_routes({"gate_update": K1_PER_REQUEST * requests,
                       "gate_update_bwd": 0,
                       "conv3x3_fused": K2_PER_REQUEST * requests,
                       **NO_LAUNCHES})
    finite = all(np.isfinite(y).all() for y in outs)
    shapes_ok = all(y.shape == (B, T, HW, HW, cfg.out_channels) for y in outs)
    emit({"phase": "serve_main_path", "requests": requests, "B": B, "T": T,
          "H": HW, "W": HW, "launches": counts, "expected": expect,
          "finite": finite, "shapes_ok": shapes_ok,
          "y_abs_max": float(max(np.abs(y).max() for y in outs))})
    if counts != expect or not finite or not shapes_ok:
        raise AssertionError("serving main path: wrong launch counts or "
                             "outputs")

    serve_checks(pred, frames, temporal_unet_apply)
    return pred, counts


def serve_checks(pred, frames, apply, phase="serve_checks"):
    """Streaming, predict_many, one HTTP round trip and the whole forward
    with the kernels on against the plain path (f32 and bf16), on a
    predictor serving B x T x HW x HW requests; ``apply`` is the model's."""
    checks = {}
    # one 4-frame request equals four 1-frame requests
    x = frames[0, 0]
    sa, sb = pred.open_session(B, HW, HW), pred.open_session(B, HW, HW)
    y_all = torch.from_numpy(pred.predict(sa, x))
    y_steps = torch.from_numpy(np.concatenate(
        [pred.predict(sb, x[:, t:t + 1]) for t in range(T)], axis=1))
    checks["streaming_rms"] = rms_rel_err(y_steps, y_all)
    # predict_many equals per-session predicts
    sc, sd, se, sf = (pred.open_session(B, HW, HW) for _ in range(4))
    many = pred.predict_many([sc, sd], [frames[0, 0], frames[1, 0]])
    single = [pred.predict(se, frames[0, 0]), pred.predict(sf, frames[1, 0])]
    checks["predict_many_rms"] = max(rms_rel_err(torch.from_numpy(a),
                                                 torch.from_numpy(b))
                                     for a, b in zip(many, single))
    # one HTTP round trip
    server = serve_http(pred, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection(*server.server_address,
                                          timeout=300)
        _, body = _post(conn, "/v1/session", json.dumps(
            {"batch": B, "height": HW, "width": HW}))
        sid = json.loads(body)["session_id"]
        xb = np.ascontiguousarray(x, "<f4")
        r, body = _post(conn, f"/v1/predict/{sid}", xb.tobytes(),
                        {"X-Shape": ",".join(map(str, xb.shape))})
        shape = tuple(int(v) for v in r.getheader("X-Shape").split(","))
        y_http = torch.from_numpy(np.frombuffer(body, "<f4").reshape(shape)
                                  .copy())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    checks["http"] = rel_err(y_http, y_all)
    # the whole forward with the kernels on against the plain path
    xn = normalize_x(torch.from_numpy(frames[1, 2]).to(DEV), pred.norm_stats)
    y = {}
    with torch.inference_mode():
        for tag, policy in (("bf16", DEFAULT_POLICY), ("f32", FP32_POLICY)):
            y[tag, "kernels"] = apply(
                pred.model, xn, policy=policy, use_pallas=True,
                use_fused_doubleconv=True)[0]
            y[tag, "plain"] = apply(pred.model, xn, policy=policy)[0]
    ref = y["f32", "plain"]
    checks["kernels_vs_plain_f32"] = rel_err(y["f32", "kernels"], ref)
    checks["kernels_vs_plain_bf16_rms"] = rms_rel_err(y["bf16", "kernels"],
                                                      y["bf16", "plain"])
    checks["kernels_bf16_vs_f32_rms"] = rms_rel_err(y["bf16", "kernels"], ref)
    checks["plain_bf16_vs_f32_rms"] = rms_rel_err(y["bf16", "plain"], ref)
    tols = {"streaming_rms": STREAM_TOL, "predict_many_rms": STREAM_TOL,
            "http": 1e-6, "kernels_vs_plain_f32": PATH_F32_TOL,
            "kernels_bf16_vs_f32_rms": min(
                PATH_BF16_RMS_TOL,
                PATH_BF16_VS_F32_RATIO * checks["plain_bf16_vs_f32_rms"])}
    ok = all(checks[k] <= tols[k] for k in tols)
    emit({"phase": phase, "rel_err": checks, "tol": tols, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase} failed: {checks}")


# ---------------------------------------------------------------------------
# 4. latency and where the time goes
# ---------------------------------------------------------------------------

def phase_latency(pred, prefix=""):
    """``prefix`` tags the phase names (``latency``, ``profile``)."""
    rng = np.random.default_rng(SEED + 1)
    out = []
    for b, t in ((B, T), (1, 1)):
        sid = pred.open_session(b, HW, HW)
        x = rng.gamma(2.0, 0.6, (b, t, HW, HW, 2)).astype(np.float32)
        for _ in range(3):
            pred.predict(sid, x)
        ms = []
        for _ in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            pred.predict(sid, x)          # ends in a copy to the host
            ms.append((time.perf_counter() - t0) * 1e3)
        pred.close_session(sid)
        out.append({"B": b, "T": t, "H": HW, "W": HW, "requests": len(ms),
                    "p50_ms": statistics.median(ms),
                    "p90_ms": sorted(ms)[int(0.9 * len(ms)) - 1],
                    "max_ms": max(ms),
                    "min_ms": min(ms),
                    "frames_per_s_p50": b * t / statistics.median(ms) * 1e3})
    emit({"phase": f"{prefix}latency", "runs": out})

    # one B=4, T=4 request under the profiler: device time by kernel
    sid = pred.open_session(B, HW, HW)
    x = rng.gamma(2.0, 0.6, (B, T, HW, HW, 2)).astype(np.float32)
    pred.predict(sid, x)
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        pred.predict(sid, x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    pred.close_session(sid)

    emit({"phase": f"{prefix}profile", "B": B, "T": T,
          **device_breakdown(prof, wall_ms)})


def kernel_group(name: str) -> str:
    """The group a device event's name belongs to, for the breakdowns."""
    return ("mc_sample_flights (K4)" if "mc_sample_flights" in name
            else "conv_int8 (K8)" if "conv_int8" in name
            else "conv3x3_fused (K2)" if "conv3x3_fused" in name
            else "gate_update_bwd (K1 backward)" if "gate_update_bwd" in name
            else "gate_update (K1)" if "gate_update" in name
            else "library conv" if ("xmma" in name or "conv" in name
                                    or "gemm" in name or "cudnn" in name)
            else "optimizer (AdamW, clip)" if ("adam" in name.lower()
                                               or "multi_tensor" in name)
            else "memcpy" if name.startswith("Memcpy")
            else "other (casts, elementwise, cat, pool, reductions)")


def device_breakdown(prof, wall_ms):
    """Device time of a profiled window by kernel group, its busy share,
    and the top kernels."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies); the host ops above them
    # carry the same time again
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0
                   and not e.key.startswith("Activity Buffer")),
                  key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in rows)
    groups = collections.Counter()
    for e in rows:
        groups[kernel_group(e.key)] += dev_us(e) / 1e3
    # kernels of an activation quantizer in torch ops: round and the
    # two-sided clamp (relu's clamp_min is not one)
    quant = [e for e in rows if re.search(
        r"round|clamp_scalar_kernel|clamp_kernel", e.key)]
    return {"wall_ms": wall_ms, "device_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e3 / wall_ms,
            "by_group_ms": dict(groups.most_common()),
            "quantizer_like_calls": sum(e.count for e in quant),
            "quantizer_like": [e.key[:90] for e in quant],
            "top": [{"name": e.key[:90], "calls": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in rows[:16]]}


def trace_breakdown(path: str, steps: int):
    """Device time by kernel group and the device's busy share in a chrome
    trace of ``steps`` steps (torch.profiler's export): the window runs from
    the first host event to the end of the last; busy is the union of the
    device events inside it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    on_device = ("kernel", "gpu_memcpy", "gpu_memset")
    host = [e for e in events if e.get("cat") not in on_device]
    t0 = min(e["ts"] for e in host)
    t1 = max(e["ts"] + e["dur"] for e in host)
    busy, reach = 0.0, t0
    groups = collections.Counter()
    for e in sorted((e for e in events if e.get("cat") in on_device),
                    key=lambda e: e["ts"]):
        groups[kernel_group(e["name"])] += e["dur"] / 1e3
        start, end = max(e["ts"], reach), min(e["ts"] + e["dur"], t1)
        if end > start:
            busy += end - start
        reach = max(reach, end)
    wall_ms = (t1 - t0) / 1e3
    return {"traced_steps": steps, "wall_ms": wall_ms,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "by_group_ms": dict(groups.most_common())}


# ---------------------------------------------------------------------------
# 5. the training step
# ---------------------------------------------------------------------------

def _snapshot(model, opt):
    return (copy.deepcopy(model.state_dict()),
            copy.deepcopy(opt.adamw.state_dict()))


def _restore(model, opt, snap):
    model.load_state_dict(snap[0])
    opt.adamw.load_state_dict(copy.deepcopy(snap[1]))


def _bitequal(a, b) -> bool:
    """Two snapshots hold the same bits."""
    (ma, oa), (mb, ob) = a, b
    return (all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(torch.equal(x, ob["state"][i][k])
                    for i, st in oa["state"].items() for k, x in st.items()))


class _Train:
    """A training path's model, data and steps: by default the benchmark's
    (Moving-MNIST B=64, T=10, 64x64 at seed 0; base_ch 32 from a seeded
    generator); or a raw batch (numpy), its norm stats and a model
    config."""

    def __init__(self, batch=None, model_cfg=benchmark.MODEL_CFG):
        x, y, self.norm = batch or benchmark.moving_mnist_batch()
        self.x = torch.from_numpy(x).to(DEV)
        self.y = torch.from_numpy(y).to(DEV)
        _, init, self.apply, _ = build_model(model_cfg)
        self.model = init(torch.Generator().manual_seed(SEED), device=DEV)
        self.init = copy.deepcopy(self.model.state_dict())

    def flags(self, policy, kernels):
        return functools.partial(self.apply, policy=policy,
                                 use_pallas=kernels,
                                 use_fused_doubleconv=kernels)

    def step(self, policy, kernels, guard=False):
        return make_train_step(self.flags(policy, kernels), self.norm,
                               guard_nonfinite_stats=guard)

    def fresh(self, **kw):
        """The model at its init and a new optimizer."""
        self.model.load_state_dict(self.init)
        return make_optimizer(self.model.named_parameters(), LR, **kw)

    def probe(self, policy, kernels):
        """One train-mode forward and backward at the init: (y_pred, the
        flat gradient, the loss)."""
        self.model.load_state_dict(self.init)
        self.model.zero_grad(set_to_none=True)
        x = normalize_x(self.x, self.norm)
        y_pred, _, _ = self.flags(policy, kernels)(self.model, x, train=True)
        loss = compute_loss(y_pred, normalize_y(self.y, self.norm),
                            compute_mask(self.x, self.norm), False)
        loss.backward()
        g = torch.cat([p.grad.flatten() for p in self.model.parameters()
                       if p.grad is not None])
        return y_pred.detach().float(), g, float(loss.detach())

    def first_pass(self):
        """The first forward and gradients, kernels against plain: in f32
        (TF32 off) relative to the plain path, in bf16 each path's RMS
        error against the f32 plain path."""
        probes = {}
        for tag, policy in (("f32", FP32_POLICY), ("bf16", DEFAULT_POLICY)):
            for kernels in (True, False):
                with (full_fp32() if tag == "f32"
                      else contextlib.nullcontext()):
                    probes[tag, kernels] = self.probe(policy, kernels)
        ref_y, ref_g, _ = probes["f32", False]
        return {
            "f32_y": rel_err(probes["f32", True][0], ref_y),
            "f32_grad_vs_norm": float((probes["f32", True][1] - ref_g).abs()
                                      .max() / ref_g.norm()),
            "bf16_kernels_y_rms": rms_rel_err(probes["bf16", True][0], ref_y),
            "bf16_plain_y_rms": rms_rel_err(probes["bf16", False][0], ref_y),
            "bf16_kernels_grad_rms": rms_rel_err(probes["bf16", True][1],
                                                 ref_g),
            "bf16_plain_grad_rms": rms_rel_err(probes["bf16", False][1],
                                               ref_g),
        }

    def step_times(self, opt, steps):
        """Step wall times, the kernel path and the plain one (``steps``
        keyed True and False) in turns over TIMED_STEPS each, after one
        warm-up step each that reads its peak memory: (runs, peak GiB)."""
        times, peak = {True: [], False: []}, {}
        for kernels in (True, False):             # warm-up, peak memory
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps[kernels](self.model, opt, self.x, self.y)
            torch.cuda.synchronize()
            peak["kernels" if kernels else "plain"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
        for block in range(4):
            for kernels in ((True, False) if block % 2 == 0
                            else (False, True)):
                for _ in range(TIMED_STEPS // 4):
                    t0 = time.perf_counter()
                    steps[kernels](self.model, opt, self.x, self.y)
                    torch.cuda.synchronize()
                    times[kernels].append((time.perf_counter() - t0) * 1e3)
        frames = self.x.shape[0] * self.x.shape[1]
        runs = {}
        for kernels, ms in times.items():
            p50 = statistics.median(ms)
            runs["kernels" if kernels else "plain"] = {
                "steps": len(ms), "p50_ms": p50,
                "p90_ms": sorted(ms)[int(0.9 * len(ms)) - 1],
                "min_ms": min(ms), "max_ms": max(ms),
                "frames_per_s_p50": frames / p50 * 1e3}
        return runs, peak

    def profiled_step(self, step, opt):
        """One step under the profiler: where its device time goes."""
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            step(self.model, opt, self.x, self.y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return device_breakdown(prof, wall_ms)


def _params_diff(a, b, model):
    """Parameters after a step, in units of lr: the share of elements
    that moved differently by more than lr/2 (``flipped``: AdamW's first
    update is about +-lr whatever |g| is, so an element whose gradient is
    smaller than the two paths' f32 difference may take the other sign)
    and the RMS over all other elements."""
    d = torch.cat([((a[n] - b[n]).float() / LR).flatten()
                   for n, _ in model.named_parameters()])
    big = d.abs() > 0.5
    return float(big.float().mean()), float(d[~big].pow(2).mean().sqrt())


def _bn_err(a, b) -> float:
    """The BN running stats' largest difference, over max(1, max|stat|)
    of each buffer (a running mean starts at 0, a running var at 1)."""
    return max(float((a[k] - b[k]).abs().max()
                     / b[k].abs().max().clamp_min(1.0))
               for k in a if k.endswith(("running_mean", "running_var")))


def _sums_err(a, b) -> float:
    """The metric sums' largest relative difference; the signed error sum
    (which may cancel to near 0) is taken relative to the |error| sum."""
    rel = [abs(float(x) / float(y) - 1) for x, y in zip(a[:3], b[:3])]
    return max(rel + [abs(float(a.err_sum - b.err_sum)) / float(b.abs_sum)])


def phase_train(tr: _Train):
    """The training step's phase, under the training paths' deterministic
    settings (core.determinism)."""
    with deterministic(DEV):
        return _phase_train(tr)


def _phase_train(tr: _Train):
    dev_name = torch.cuda.get_device_name(0)
    bf16, f32 = DEFAULT_POLICY, FP32_POLICY
    # -- the main path: bf16, both kernel flags on, launch counts read ----
    opt = tr.fresh()
    step = tr.step(bf16, True)
    torch.cuda.synchronize()
    reset_launches()
    losses = [float(step(tr.model, opt, tr.x, tr.y)[0])
              for _ in range(TRAIN_STEPS)]
    counts = path_counts()
    expect = on_main_routes({"gate_update": K1_PER_STEP * TRAIN_STEPS,
                       "gate_update_bwd": K1_PER_STEP * TRAIN_STEPS,
                       "conv3x3_fused": K2_PER_STEP * TRAIN_STEPS,
                       **NO_LAUNCHES})
    finite = all(math.isfinite(v) for v in losses)
    emit({"phase": "train_main_path", "steps": TRAIN_STEPS, "B": TB,
          "T": TT, "H": THW, "W": THW, "base_ch": TBASE, "dtype": "bfloat16",
          "losses": losses, "launches": counts, "expected": expect,
          "finite": finite})
    if counts != expect or not finite:
        raise AssertionError("training main path: wrong launch counts or "
                             "non-finite loss")
    # the same three steps with both flags off, from the same init
    opt = tr.fresh()
    plain = tr.step(bf16, False)
    plain_losses = [float(plain(tr.model, opt, tr.x, tr.y)[0])
                    for _ in range(TRAIN_STEPS)]

    # -- kernels against plain: the first forward and gradients ----------
    checks = tr.first_pass()
    # -- f32 steps, kernels and plain each from the same state -----------
    step_k, step_p = tr.step(f32, True), tr.step(f32, False)
    opt = tr.fresh()
    f32_steps = []
    with full_fp32():
        for _ in range(TRAIN_STEPS):
            before = _snapshot(tr.model, opt)
            lk, sk = step_k(tr.model, opt, tr.x, tr.y)
            after_k = _snapshot(tr.model, opt)
            _restore(tr.model, opt, before)
            lp, sp = step_p(tr.model, opt, tr.x, tr.y)
            after_p = _snapshot(tr.model, opt)
            flipped, rms = _params_diff(after_k[0], after_p[0], tr.model)
            f32_steps.append({
                "loss": [float(lk), float(lp)],
                "loss_rel": abs(float(lk) / float(lp) - 1),
                "sums_err": _sums_err(sk, sp), "params_flipped": flipped,
                "params_rms_lr": rms,
                "bn_err": _bn_err(after_k[0], after_p[0])})
            _restore(tr.model, opt, after_k)
            del before, after_k, after_p
    tol = TRAIN_F32_TOL
    ok = (checks["f32_y"] <= PATH_F32_TOL
          and checks["f32_grad_vs_norm"] <= tol["grad"]
          and all(s["loss_rel"] <= tol["loss"] and s["sums_err"] <= tol["sums"]
                  and s["params_flipped"] <= tol["params_flipped"]
                  and s["params_rms_lr"] <= tol["params_rms_lr"]
                  and s["bn_err"] <= tol["bn"] for s in f32_steps)
          and checks["bf16_kernels_y_rms"] <= min(
              PATH_BF16_RMS_TOL,
              PATH_BF16_VS_F32_RATIO * checks["bf16_plain_y_rms"])
          and checks["bf16_kernels_grad_rms"] <= PATH_BF16_VS_F32_RATIO
          * checks["bf16_plain_grad_rms"])
    emit({"phase": "train_checks", "bf16_losses": {"kernels": losses,
                                                   "plain": plain_losses},
          "first_pass": checks, "f32_steps": f32_steps,
          "tol": dict(tol, f32_y=PATH_F32_TOL,
                      bf16_ratio=PATH_BF16_VS_F32_RATIO,
                      bf16_y_rms=PATH_BF16_RMS_TOL), "ok": ok})
    if not ok:
        raise AssertionError("training checks failed")

    # -- a NaN batch under the non-finite skip leaves the state ----------
    opt = tr.fresh(skip_nonfinite=3)
    guarded = tr.step(bf16, True, guard=True)
    guarded(tr.model, opt, tr.x, tr.y)
    before = _snapshot(tr.model, opt)
    x_nan = tr.x.clone()
    x_nan[0, 0, 0, 0, 0] = float("nan")
    nan_loss = float(guarded(tr.model, opt, x_nan, tr.y)[0])
    untouched = _bitequal(_snapshot(tr.model, opt), before)
    emit({"phase": "train_nan_batch", "loss": nan_loss,
          "notfinite_count": opt.notfinite_count, "untouched": untouched})
    if math.isfinite(nan_loss) or not untouched or opt.notfinite_count != 1:
        raise AssertionError("a NaN batch changed the training state")
    del before

    # -- step time, kernels and plain in turns; peak memory --------------
    opt = tr.fresh()
    runs, peak = tr.step_times(opt, {True: step, False: plain})
    emit({"phase": "train_step_time", "device": dev_name, "B": TB, "T": TT,
          "H": THW, "base_ch": TBASE, "dtype": "bfloat16", **runs,
          "peak_memory_gib": peak})

    # -- one kernels step under the profiler ------------------------------
    emit({"phase": "train_profile", "B": TB, "T": TT,
          **tr.profiled_step(step, opt)})
    return counts, runs


# ---------------------------------------------------------------------------
# 6. stage B: the Monte-Carlo path tracer, and gen-renders
# ---------------------------------------------------------------------------

def mc_patches():
    """The two production patches of scripts/perf/bench_mc.py:13-23:
    "broad" (β_max 0.01, where the majorant grid loses) and "dense" (β_max
    0.15, where it wins), [Z, Y, X] f32."""
    z, y, x = np.meshgrid(np.arange(MC_NZ), np.arange(MC_NXY),
                          np.arange(MC_NXY), indexing="ij")
    return {
        "broad": (0.01 * np.exp(-(((z - 60) / 30.0) ** 2
                                  + ((y - 64) / 40.0) ** 2
                                  + ((x - 64) / 40.0) ** 2))
                  ).astype(np.float32),
        "dense": (0.15 * np.exp(-(((z - 60) / 12.0) ** 2
                                  + ((y - 64) / 12.0) ** 2
                                  + ((x - 64) / 12.0) ** 2))
                  ).astype(np.float32)}


def _mc_view(scene, t_sun, cell, fused, spp=MC_SPP, seed=0, **over):
    """One MC view through ``mc_radiance``, launch counts read around it:
    (image, wall s, stats, counts)."""
    kw = dict(MC_CAMERA, **over)
    stats = {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    img = mc_reference.mc_radiance(
        scene, kw.pop("origin"), kw.pop("target"), kw.pop("up"), **kw,
        spp=spp, max_depth=MC_DEPTH, t_sun=t_sun, seed=seed,
        majorant_cell=cell, use_fused_sampler=fused, stats=stats)
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0, stats, launch_counts()


def phase_mc():
    """Every (patch, route, cell) view of the production geometry, the
    card against the CPU, one profiled view. Returns the K4 launches of
    the fused views and their iterations."""
    patches = mc_patches()
    sun = np.asarray(MC_CAMERA["sun_dir"], np.float32)
    sun = sun / np.linalg.norm(sun)
    views, k4_launches, k4_iters, ok = [], 0, 0, True
    for name, beta in patches.items():
        scene = VolumeScene(torch.from_numpy(beta).to(DEV), 20.0)
        t0 = time.perf_counter()
        t_sun = sun_transmittance(scene, sun)
        torch.cuda.synchronize()
        t_sun_s = time.perf_counter() - t0
        auto = mc_reference.auto_majorant_cell(float(beta.max()),
                                               scene.diagonal)
        routes = [(c, True) for c in MC_CELLS] + [(auto, False)]
        res = {}
        for cell, fused in routes:
            _mc_view(scene, t_sun, cell, fused, spp=1)        # warm-up
            img, wall, stats, counts = _mc_view(scene, t_sun, cell, fused)
            rm = np.asarray(stats["round_means"])[:, 0]
            expect = dict({k: 0 for k in counts}, mc_sample_flights=(
                stats["iterations"] if fused else 0))
            finite = bool(torch.isfinite(img).all())
            nonneg = bool((img >= 0).all())
            line = {"phase": "mc_view", "patch": name, "beta_max":
                    float(beta.max()), "route": "fused" if fused
                    else "threefry", "majorant_cell": cell,
                    "auto_cell": auto, "spp": MC_SPP, "wall_s": wall,
                    "iterations": stats["iterations"],
                    "max_events": mc_reference.default_max_events(
                        float(beta.max()), scene.diagonal, 20.0, cell),
                    "launches": counts, "mean": float(img.mean()),
                    "se": float(rm.std(ddof=1) / np.sqrt(len(rm))),
                    "finite": finite, "nonnegative": nonneg,
                    "t_sun_s": t_sun_s}
            line["ok"] = counts == expect and finite and nonneg
            emit(line)
            views.append(line)
            ok = ok and line["ok"]
            res[cell, fused] = line
            if fused:
                k4_launches += counts["mc_sample_flights"]
                k4_iters += stats["iterations"]
        ref = res[auto, False]
        for cell in MC_CELLS:
            f = res[cell, True]
            z = abs(f["mean"] - ref["mean"]) / max(
                math.hypot(f["se"], ref["se"]), 1e-30)
            good = z <= MC_SE_LIMIT
            emit({"phase": "mc_fused_vs_threefry", "patch": name,
                  "fused_cell": cell, "threefry_cell": auto,
                  "fused_mean": f["mean"], "threefry_mean": ref["mean"],
                  "z": z, "limit": MC_SE_LIMIT, "ok": good})
            ok = ok and good
    if not ok:
        raise AssertionError("MC views: wrong launch counts, bad images or "
                             "fused and threefry apart")

    # the threefry route on the card against the same code on the CPU: the
    # broad patch at 64x64 seen from 20 km (at 600 km an ulp of a ray moves
    # its entry point by 0.04 m, and the devices' norms differ in an ulp)
    near = dict(origin=(0, 0, 20_000.0), resolution=(64, 64), fov_deg=8.0)
    beta = patches["broad"]
    imgs = []
    for dev in (DEV, "cpu"):
        scene = VolumeScene(torch.from_numpy(beta).to(dev), 20.0)
        t_sun = sun_transmittance(scene, sun)
        kw = dict(MC_CAMERA, **near)
        imgs.append(mc_reference.mc_radiance(
            scene, kw.pop("origin"), kw.pop("target"), kw.pop("up"), **kw,
            spp=4, max_depth=MC_DEPTH, t_sun=t_sun, seed=1,
            majorant_cell=0).cpu().numpy())
    a, b = imgs
    mean_rel = float(abs(a.mean() / b.mean() - 1))
    off = float((np.abs(a - b) > 1e-4 * np.abs(b)).mean())
    good = bool(np.isfinite(a).all()) and mean_rel <= 1e-4 and off <= 0.01
    emit({"phase": "mc_card_vs_cpu", "patch": "broad", "res": 64,
          "spp": 4, "mean_rel": mean_rel, "pixels_off_share": off,
          "pixels_off": int(round(off * a.size)), "tol": MC_CROSS_TOL,
          "ok": good})
    if not good:
        raise AssertionError("MC: the card and the CPU disagree")

    # one profiled fused view: the dense patch at its auto cell
    scene = VolumeScene(torch.from_numpy(patches["dense"]).to(DEV), 20.0)
    t_sun = sun_transmittance(scene, sun)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        _, wall, stats, _ = _mc_view(scene, t_sun, 16, True)
    emit({"phase": "mc_profile", "patch": "dense", "route": "fused",
          "majorant_cell": 16, "iterations": stats["iterations"],
          **device_breakdown(prof, wall * 1e3)})
    return k4_launches, k4_iters, views


def _pkls(root):
    out = {}
    for folder in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, folder))):
            path = os.path.join(root, folder, name)
            with open(path, "rb") as f:
                raw = f.read()
            out[f"{folder}/{name}"] = (raw, pickle.loads(raw))
    return out


def render_tree(workdir: str):
    """Stage B's input at the production geometry: the two production
    patches and a 2-view overpass CSV. Folders take the CSV's times in
    turn (render_all.py:89-92): the patches sit in the 7th folder, which
    gets the 7th time, when the synthetic pass is near nadir (sat zenith
    ~15 deg), so that both views see the clouds; folders 1-6 are empty.
    Returns (patch root, CSV path)."""
    root = os.path.join(workdir, "patches")
    for k in range(1, 7):
        os.makedirs(os.path.join(root, f"{k:010d}"))
    src = os.path.join(root, f"{7:010d}")
    os.makedirs(src)
    for i, beta in enumerate(mc_patches().values()):
        with open(os.path.join(src, f"sample_{i:03d}.pkl"), "wb") as f:
            pickle.dump({"beta_ext": beta}, f)
    return root, synthesize_overpass_csv(
        os.path.join(workdir, "overpass.csv"), n_times=7, n_satellites=2)


RENDER_MC_FLAGS = ["--mc-spp", str(MC_SPP), "--mc-majorant-cell", "16"]


def _raw(root):
    """{relative path: file bytes} of a pkl tree."""
    return {k: raw for k, (raw, _) in _pkls(root).items()}


def phase_renders(workdir: str):
    """``gen-renders`` through the port's CLI on ``render_tree``'s input:
    deterministic, MC, MC batched, MC again. Returns the batched MC run's
    pkls ({path: bytes}), which phase 19's ranks must reproduce."""
    root, csv = render_tree(workdir)
    base = ["gen-renders", "--input", root, "--csv", csv, "--res",
            str(MC_RES)]
    mc = RENDER_MC_FLAGS
    runs = {"deterministic": [], "mc": mc, "mc_batch": mc + ["--batch", "2"],
            "mc_rerun": mc}
    out, walls, counts = {}, {}, {}
    for tag, extra in runs.items():
        dst = os.path.join(workdir, tag)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            cli_main(base + ["--output", dst] + extra)
        walls[tag] = time.perf_counter() - t0
        counts[tag] = launch_counts()
        out[tag] = _pkls(dst)
    names = sorted(out["mc"])
    schema = all(
        len(o) == 4 and sorted(o) == names
        and all(set(d) == {"render", "timestamp", "satellite_idx"}
                and d["render"].shape == (MC_RES, MC_RES)
                and d["render"].dtype == np.float32
                and np.isfinite(d["render"]).all()
                and (d["render"] >= 0).all() for _, d in o.values())
        for o in out.values())
    batch_err = max(float(np.abs(out["mc_batch"][k][1]["render"]
                                 - out["mc"][k][1]["render"]).max()
                          / max(np.abs(out["mc"][k][1]["render"]).max(),
                                1e-30)) for k in names)
    batch_ok = all(np.allclose(out["mc_batch"][k][1]["render"],
                               out["mc"][k][1]["render"], rtol=1e-6,
                               atol=1e-8) for k in names)
    rerun_equal = all(out["mc_rerun"][k][0] == out["mc"][k][0]
                      for k in names)
    lit = all(d["render"].max() > 0 for o in out.values()
              for _, d in o.values())
    ok = schema and lit and batch_ok and rerun_equal and all(
        sum(c.values()) == 0 for c in counts.values())
    emit({"phase": "gen_renders", "pkls": names, "wall_s": walls,
          "launches": counts, "schema_ok": schema, "all_lit": lit,
          "batched_vs_serial_rel": batch_err, "batched_equal": batch_ok,
          "rerun_byte_equal": rerun_equal,
          "means": {k: float(v[1]["render"].mean())
                    for k, v in out["mc"].items()}, "ok": ok})
    if not ok:
        raise AssertionError("gen-renders checks failed")
    return _raw(os.path.join(workdir, "mc_batch"))


# ---------------------------------------------------------------------------
# 8. the probe entry points
# ---------------------------------------------------------------------------

def _run_module(module: str):
    """``python -m module`` from the repo root: (stdout lines, the launch
    counts its last line reports)."""
    r = subprocess.run([sys.executable, "-m", module], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    sys.stderr.write(r.stderr[-4000:])
    if r.returncode != 0:
        raise AssertionError(f"{module} exited {r.returncode}")
    lines = r.stdout.strip().splitlines()
    tag, counts = lines[-1].split(" ", 1)
    if tag != "launches":
        raise AssertionError(f"{module}: no launch counts in {lines[-1]!r}")
    return lines, json.loads(counts)


def phase_probes():
    """Both probes as a user runs them; each resets the counts before its
    run and prints them after. Returns the launch counts."""
    bn_lines, bn = _run_module("unet_convlstm_tpu_torch.probes.bn_kernel_proto")
    g_lines, g = _run_module("unet_convlstm_tpu_torch.probes.probe_gather")
    expect = {"channel_sum_sumsq": bn_kernel_proto.ITERS + 1,
              "chained_gather": len(probe_gather.VARIANTS)
              * (2 + probe_gather.ITERS)}
    counts = {**bn, **g}
    ok = ("parity OK" in bn_lines and counts == expect
          and sum(": OK " in ln for ln in g_lines) == len(
              probe_gather.VARIANTS) and not any("WRONG" in ln
                                                 for ln in g_lines))
    emit({"phase": "probes", "bn_kernel_proto": bn_lines,
          "probe_gather": g_lines, "launches": counts, "expected": expect,
          "ok": ok})
    if not ok:
        raise AssertionError("probe entry points failed")
    return counts


# ---------------------------------------------------------------------------
# 9. the training run, and 10. the overfit gate
# ---------------------------------------------------------------------------

def _cli(argv):
    """The port's CLI in this process: its stdout (echoed to stderr)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    sys.stderr.write(buf.getvalue())
    return buf.getvalue()


def _scaled(counts, k):
    return {name: n * k for name, n in counts.items()}


def phase_fit(workdir: str):
    """gen-mnist, train 2 epochs, resume for 1, serve the best checkpoint,
    one profiled epoch. Returns (npz path, launches of the CLI runs)."""
    npz = os.path.join(workdir, "mnist_seq10.npz")
    ck = os.path.join(workdir, "ckpts")
    t0 = time.perf_counter()
    _cli(["gen-mnist", "--out", npz, "--seq-len", str(TT), "--num-samples",
          str(FIT_SAMPLES), "--image-size", str(THW), "--seed", str(SEED),
          "--xy"])
    gen_s = time.perf_counter() - t0
    with open(FIT_CONFIG) as f:
        cfg = TrainConfig.from_dict(json.load(f))
    steps = int(cfg.train_frac * FIT_SAMPLES) // cfg.batch_size
    evals = math.ceil((FIT_SAMPLES - int(cfg.train_frac * FIT_SAMPLES))
                      / cfg.batch_size)
    per_epoch = on_main_routes({
        "gate_update": (steps + evals) * K1_PER_STEP,
        "gate_update_bwd": steps * K1_PER_STEP,
        "conv3x3_fused": (steps + evals) * K2_PER_STEP, **NO_LAUNCHES})
    last = os.path.join(ck, "custom_last.pt")
    runs = {}
    for tag, flags, n_epochs in (("train", [], FIT_EPOCHS),
                                 ("resume", ["--resume", last], 1)):
        torch.cuda.synchronize()
        reset_launches()
        fast_gather.calls_by_route.update(native=0, numpy=0)
        t0 = time.perf_counter()
        out = _cli(["train", "--config", FIT_CONFIG, "--npz", npz, *flags,
                    f"checkpoint_dir={ck}",
                    f"epochs={FIT_EPOCHS + (tag == 'resume')}"])
        runs[tag] = {"wall_s": time.perf_counter() - t0,
                     "launches": path_counts(),
                     "gather_routes": dict(fast_gather.calls_by_route),
                     "expected": _scaled(per_epoch, n_epochs),
                     "epoch_lines": [ln for ln in out.splitlines()
                                     if ln.startswith("Epoch ")]}
    runs["resume"]["resumed_at_epoch_3"] = (
        f"resumed from {last} at epoch {FIT_EPOCHS + 1}"
        in out)
    with open(os.path.join(ck, "history.csv"), newline="") as f:
        history = list(csv.DictReader(f))
    frames = steps * cfg.batch_size * TT
    epochs = [{"epoch": int(r["epoch"]), "train_loss": float(r["train_loss"]),
               "val_loss": float(r["val_loss"]),
               "val_mae": float(r["val_mae"]),
               "train_time_s": float(r["train_time_s"]),
               "frames_per_s": frames / float(r["train_time_s"])}
              for r in history]

    # one request served from the best checkpoint
    pred = StreamingPredictor(os.path.join(ck, "custom_best.pt"), device=DEV)
    frame = np.ascontiguousarray(np.moveaxis(np.load(npz)["X"][:1, :1], 2,
                                             -1))
    sid = pred.open_session(1, THW, THW)
    torch.cuda.synchronize()
    reset_launches()
    y = pred.predict(sid, frame)
    serve = {"launches": path_counts(), "expected": on_main_routes(dict(
        NO_LAUNCHES, gate_update=sum(n for *_, n in k1_levels(TBASE, THW, 1)),
        gate_update_bwd=0, conv3x3_fused=K2_PER_STEP)),
        "shape": list(y.shape), "finite": bool(np.isfinite(y).all())}
    del pred

    # one more epoch with the loop's own trace of steps 10-20: the device's
    # busy share in the steady state
    trace_dir = os.path.join(workdir, "trace")
    torch.cuda.synchronize()
    reset_launches()
    out = _cli(["train", "--config", FIT_CONFIG, "--npz", npz, "--resume",
                last, "--profile-dir", trace_dir, f"checkpoint_dir={ck}",
                f"epochs={FIT_EPOCHS + 2}"])
    prof_counts = path_counts()
    with open(os.path.join(ck, "history.csv"), newline="") as f:
        row = list(csv.DictReader(f))[-1]
    profiled = {"epoch": int(row["epoch"]),
                "train_time_s": float(row["train_time_s"]),
                "frames_per_s": frames / float(row["train_time_s"]),
                "launches": prof_counts, "expected": per_epoch,
                "epoch_lines": [ln for ln in out.splitlines()
                                if ln.startswith("Epoch ")],
                **trace_breakdown(os.path.join(trace_dir, "trace.json"),
                                  PROFILE_STEPS[1] - PROFILE_STEPS[0])}

    # the host's data path alone over one epoch of train batches: the
    # gather (native, x and y a batch), and the gather with the copies to
    # the card
    ds = NPZSequenceDataset(npz)
    loader = SequenceLoader(ds, ds.train_val_split(cfg.train_frac,
                                                   cfg.split_seed)[0],
                            cfg.batch_size, seed=cfg.seed,
                            drop_remainder=True)
    fast_gather.calls_by_route.update(native=0, numpy=0)
    t0 = time.perf_counter()
    for _ in loader:
        pass
    gather_s = time.perf_counter() - t0
    gather_routes = dict(fast_gather.calls_by_route)
    t0 = time.perf_counter()
    for _ in prefetch_to_device(loader, 2, DEV):
        pass
    torch.cuda.synchronize()
    data_path = {"batches": len(loader), "gather_routes": gather_routes,
                 "gather_ms_per_batch": gather_s / len(loader) * 1e3,
                 "gather_and_copy_ms_per_batch":
                     (time.perf_counter() - t0) / len(loader) * 1e3}
    del ds, loader

    ok = (all(r["launches"] == r["expected"] for r in runs.values())
          and all(r["gather_routes"]["numpy"] == 0
                  and r["gather_routes"]["native"] > 0
                  for r in runs.values())
          and gather_routes == {"native": 2 * data_path["batches"],
                                "numpy": 0}
          and runs["resume"]["resumed_at_epoch_3"]
          and len(runs["resume"]["epoch_lines"]) == 1
          and runs["resume"]["epoch_lines"][0].startswith(
              f"Epoch {FIT_EPOCHS + 1}/")
          and [e["epoch"] for e in epochs] == list(range(1,
                                                          FIT_EPOCHS + 2))
          and all(math.isfinite(e["train_loss"]) and math.isfinite(
              e["val_loss"]) for e in epochs)
          and serve["launches"] == serve["expected"] and serve["finite"]
          and serve["shape"] == [1, 1, THW, THW, 1]
          and prof_counts == per_epoch
          and profiled["epoch"] == FIT_EPOCHS + 2
          and len(profiled["epoch_lines"]) == 1)
    emit({"phase": "fit", "config": os.path.relpath(FIT_CONFIG, ROOT),
          "samples": FIT_SAMPLES, "B": cfg.batch_size, "T": TT, "H": THW,
          "base_ch": cfg.model["base_ch"], "train_steps_per_epoch": steps,
          "eval_batches_per_epoch": evals, "gen_mnist_s": gen_s,
          "runs": runs, "history": epochs, "serve": serve,
          "traced_epoch": profiled, "data_path": data_path, "ok": ok})
    if not ok:
        raise AssertionError("training run checks failed")
    return npz, {k: runs["train"]["launches"][k]
                 + runs["resume"]["launches"][k] for k in per_epoch}


def phase_overfit(npz: str, workdir: str):
    """The overfit gate through the CLI; its exit code says whether it
    converged (the loss below 5e-4), which 300 steps need not reach."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(["overfit", "--npz", npz, "--base-ch", str(OVERFIT_BASE),
                      "--num-samples", str(OVERFIT_SAMPLES), "--max-iters",
                      str(OVERFIT_ITERS), "--out-dir",
                      os.path.join(workdir, "overfit")])
            code = 0
        except SystemExit as e:       # the gate's verdict, 0 or 1
            code = e.code
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    sys.stderr.write(out)
    counts = path_counts()
    losses = [float(ln.split("loss")[1]) for ln in out.splitlines()
              if ln.startswith("iter ")]
    iters = 100 * len(losses)
    expect = on_main_routes(dict(NO_LAUNCHES,
                                 gate_update=iters * K1_PER_STEP,
                                 gate_update_bwd=iters * K1_PER_STEP,
                                 conv3x3_fused=iters * K2_PER_STEP))
    ok = (code in (0, 1)
          and (len(losses) == OVERFIT_ITERS // 100 or code == 0)
          and all(math.isfinite(v) for v in losses)
          and all(v < losses[0] for v in losses[1:])
          and losses[-1] == min(losses) and counts == expect)
    emit({"phase": "overfit", "base_ch": OVERFIT_BASE,
          "samples": OVERFIT_SAMPLES, "max_iters": OVERFIT_ITERS,
          "exit_code": code, "converged": code == 0, "chunk_losses": losses,
          "wall_s": wall, "launches": counts, "expected": expect, "ok": ok})
    if not ok:
        raise AssertionError("overfit gate: bad losses or launch counts")


# ---------------------------------------------------------------------------
# 11. the ResNet18 family
# ---------------------------------------------------------------------------

def resnet_k1_levels(hw, t, layers):
    """The gate updates of one resnet pass: (level, hidden C, map side,
    launches) of the bottleneck and the four skip ConvLSTMs."""
    return [(level, C, hw // d, layers * t) for level, C, d in (
        ("bottleneck", 512, 32), ("skip3", 256, 16), ("skip2", 128, 8),
        ("skip1", 64, 4), ("skip0", 64, 2))]


def _resnet_cfg(pth=None):
    """configs/cloud_resnet.json's model, with ``pretrained_path``."""
    with open(RESNET_CONFIG) as f:
        cfg = json.load(f)["model"]
    return dict(cfg, pretrained_path=pth) if pth else cfg


def _encoder_equal(state, enc) -> bool:
    """A model state dict's ``encoder.*`` entries hold the bits of a
    torchvision-named encoder state dict."""
    return all(torch.equal(state[f"encoder.{k}"].cpu(), t.cpu())
               for k, t in enc.items())


def resnet_serve(workdir: str):
    """An encoder .pth from a seeded model with calibrated BatchNorms; the
    cloud_resnet model frozen on it, saved as a .pt (pretrained_resolved)
    and served: 2 sessions x 3 requests at B=4, T=4, 128x128, launch
    counts read around them, then the serving checks. Returns (predictor,
    launches, the .pth's path)."""
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    X = (rng.gamma(2.0, 0.6, (8, T, HW, HW, 2))).astype(np.float32)
    Y = (rng.standard_normal((8, T, HW, HW, 1)) * 5).astype(np.float32)
    norm = compute_norm_stats(X, Y)
    xn = normalize_x(torch.from_numpy(X[:B]).to(DEV), norm)
    donor_cfg = dict(_resnet_cfg(), freeze_encoder=False)
    _, init, apply, _ = build_model(donor_cfg)
    donor = init(torch.Generator().manual_seed(SEED + 3), device=DEV)
    calibrate_bn(donor, xn, apply)
    pth = save_resnet18_encoder_pth(donor.state_dict(),
                                    os.path.join(workdir, "resnet18-enc.pth"))
    del donor
    model_cfg = _resnet_cfg(pth)
    cfg, init, apply, _ = build_model(model_cfg)
    if not cfg.freeze_encoder:
        raise AssertionError("the .pth did not freeze the encoder")
    # the decoder's BatchNorms keep their init: calibrated on one batch,
    # the random decoder's near-constant channels take gains up to
    # 1/sqrt(eps) and bf16 alone moves its output by ~27% RMS (both
    # paths, and JAX's alike); the calibrated encoder keeps the ConvLSTMs'
    # inputs at unit scale
    model = init(torch.Generator().manual_seed(SEED), device=DEV)
    saved = dict(model_cfg, pretrained_resolved=True)
    saved.pop("pretrained_path")
    ckpt = save_checkpoint(os.path.join(workdir, "resnet18.pt"),
                           model.state_dict(), saved, norm.to_dict())
    del model
    pred = StreamingPredictor(ckpt, device=DEV)
    pred.warmup(B, HW, HW, T)
    torch.cuda.synchronize()
    enc = torch.load(pth, weights_only=True)
    emit({"phase": "resnet_serve_setup", "config": cfg.to_dict(),
          "params": sum(p.numel() for p in pred.model.parameters()),
          "encoder_from_pth": _encoder_equal(pred.model.state_dict(), enc),
          "checkpoint_mb": os.path.getsize(ckpt) / 2**20,
          "setup_s": time.perf_counter() - t0})

    frames = (rng.gamma(2.0, 0.6, (SESSIONS, REQUESTS_PER_SESSION, B, T, HW,
                                   HW, 2))).astype(np.float32)
    sids = [pred.open_session(B, HW, HW) for _ in range(SESSIONS)]
    per_request = sum(n for *_, n in resnet_k1_levels(HW, T,
                                                      cfg.lstm_layers))
    reset_launches()
    outs = [pred.predict(sid, frames[s, r])
            for r in range(REQUESTS_PER_SESSION)
            for s, sid in enumerate(sids)]
    counts = path_counts()
    requests = SESSIONS * REQUESTS_PER_SESSION
    expect = on_main_routes({"gate_update": per_request * requests,
                             "gate_update_bwd": 0, "conv3x3_fused": 0,
                             **NO_LAUNCHES})
    finite = all(np.isfinite(y).all() for y in outs)
    shapes_ok = all(y.shape == (B, T, HW, HW, 1) for y in outs)
    emit({"phase": "resnet_serve_main_path", "requests": requests, "B": B,
          "T": T, "H": HW, "W": HW, "launches_per_request": per_request,
          "launches": counts, "expected": expect, "finite": finite,
          "shapes_ok": shapes_ok,
          "y_abs_max": float(max(np.abs(y).max() for y in outs))})
    if (counts != expect or not finite or not shapes_ok
            or not _encoder_equal(pred.model.state_dict(), enc)):
        raise AssertionError("resnet serving main path: wrong launch "
                             "counts, outputs or encoder")
    serve_checks(pred, frames, apply, phase="resnet_serve_checks")
    return pred, counts, pth


def resnet_train(pth: str):
    """The family's training step at its production geometry (B=32, T=12,
    128x128, bf16, AdamW lr 1e-3, wd 1e-4, clip 1.0, the encoder frozen on
    the .pth): 3 steps with the launch counts read around them and the
    encoder bit-equal after; kernels against plain (f32, bf16); step times
    and peak memory; one profiled step; then one step with the encoder
    unfrozen. Returns (launches of the main path, per-step launches)."""
    rng = np.random.default_rng(SEED + 4)
    x = rng.gamma(2.0, 0.6, (RB, RT, RHW, RHW, 2)).astype(np.float32)
    y = (rng.standard_normal((RB, RT, RHW, RHW, 1)) * 5).astype(np.float32)
    model_cfg = _resnet_cfg(pth)
    tr = _Train((x, y, compute_norm_stats(x, y)), model_cfg)
    del x, y
    mask = _trainable_mask(tr.model, model_cfg)
    if not model_cfg["freeze_encoder"] or mask is None:
        raise AssertionError("the training model's encoder is not frozen")
    per_step = sum(n for *_, n in resnet_k1_levels(
        RHW, RT, model_cfg["lstm_layers"]))
    bf16 = DEFAULT_POLICY

    def encoder(model):
        return {k: v.detach().clone() for k, v in
                model.encoder.state_dict().items()}

    # -- the main path: bf16, kernels on, launch counts read --------------
    opt = tr.fresh(trainable_mask=mask)
    step = tr.step(bf16, True)
    enc0 = encoder(tr.model)
    torch.cuda.synchronize()
    reset_launches()
    losses = [float(step(tr.model, opt, tr.x, tr.y)[0])
              for _ in range(TRAIN_STEPS)]
    counts = path_counts()
    expect = on_main_routes({"gate_update": per_step * TRAIN_STEPS,
                             "gate_update_bwd": per_step * TRAIN_STEPS,
                             "conv3x3_fused": 0, **NO_LAUNCHES})
    enc_same = all(torch.equal(enc0[k], v)
                   for k, v in encoder(tr.model).items())
    moved = not torch.equal(tr.init["segmentation_head.0.weight"],
                            tr.model.segmentation_head[0].weight)
    finite = all(math.isfinite(v) for v in losses)
    emit({"phase": "resnet_train_main_path", "steps": TRAIN_STEPS, "B": RB,
          "T": RT, "H": RHW, "W": RHW, "dtype": "bfloat16",
          "launches_per_step": per_step, "losses": losses,
          "launches": counts, "expected": expect, "finite": finite,
          "encoder_bit_equal": enc_same, "decoder_moved": moved})
    if counts != expect or not finite or not enc_same or not moved:
        raise AssertionError("resnet training main path: wrong launch "
                             "counts, a non-finite loss or a moved encoder")

    # -- kernels against plain: the first forward and gradients -----------
    checks = tr.first_pass()
    # in bf16 only the ratio to the plain path holds: train-mode BN over
    # the random decoder compounds bf16's rounding layer by layer, ~25%
    # RMS off the f32 forward on both paths at this geometry on an H100
    # (28% on the CPU at B=4-8, T=4; the JAX package's bf16 path is as far
    # off its f32 one on such a model), so PATH_BF16_RMS_TOL does not apply
    tols = {"f32_y": PATH_F32_TOL, "f32_grad_vs_norm": TRAIN_F32_TOL["grad"],
            "bf16_kernels_y_rms": PATH_BF16_VS_F32_RATIO
            * checks["bf16_plain_y_rms"],
            "bf16_kernels_grad_rms": PATH_BF16_VS_F32_RATIO
            * checks["bf16_plain_grad_rms"]}
    ok = all(checks[k] <= tols[k] for k in tols)
    emit({"phase": "resnet_train_checks", "first_pass": checks, "tol": tols,
          "ok": ok})
    if not ok:
        raise AssertionError(f"resnet training checks failed: {checks}")

    # -- step time, kernels and plain in turns; peak memory --------------
    opt = tr.fresh(trainable_mask=mask)
    runs, peak = tr.step_times(opt, {True: step, False: tr.step(bf16, False)})
    emit({"phase": "resnet_train_step_time",
          "device": torch.cuda.get_device_name(0), "B": RB, "T": RT,
          "H": RHW, "dtype": "bfloat16", **runs, "peak_memory_gib": peak})
    emit({"phase": "resnet_train_profile", "B": RB, "T": RT,
          **tr.profiled_step(step, opt)})

    # -- one step with the encoder unfrozen (its BN on batch stats) -------
    open_cfg = dict(model_cfg, freeze_encoder=False)
    _, init, apply, _ = build_model(open_cfg)
    x, y, norm, init_state = tr.x, tr.y, tr.norm, tr.init
    del tr, opt, step
    torch.cuda.empty_cache()
    model = init(device=DEV)
    model.load_state_dict(init_state)
    opt = make_optimizer(model.named_parameters(), LR,
                         trainable_mask=_trainable_mask(model, open_cfg))
    open_step = make_train_step(functools.partial(
        apply, policy=bf16, use_pallas=True, use_fused_doubleconv=True),
        norm)
    enc0 = encoder(model)
    torch.cuda.synchronize()
    reset_launches()
    loss = float(open_step(model, opt, x, y)[0])
    open_counts = path_counts()
    open_expect = on_main_routes({"gate_update": per_step,
                                  "gate_update_bwd": per_step,
                                  "conv3x3_fused": 0, **NO_LAUNCHES})
    enc1 = encoder(model)
    changed = {k: not torch.equal(enc0[k], enc1[k]) for k in enc0
               if not k.endswith("num_batches_tracked")}
    ok = (open_counts == open_expect and math.isfinite(loss)
          and all(changed.values()))
    emit({"phase": "resnet_train_unfrozen", "loss": loss,
          "launches": open_counts, "expected": open_expect,
          "encoder_entries_changed": sum(changed.values()),
          "encoder_entries": len(changed), "ok": ok})
    if not ok:
        raise AssertionError("resnet unfrozen step: wrong launch counts or "
                             "an encoder entry that did not move")
    return counts, per_step


def resnet_cli(workdir: str, npz: str, pth: str):
    """``train`` (configs/cloud_resnet.json, the encoder frozen on a copy
    of the .pth) one epoch on the fit phase's gen-mnist data, the .pth
    deleted, a resume for one more epoch, then one request served from
    ``resnet18_best.pt``. Returns the launches of the two training runs."""
    ck = os.path.join(workdir, "resnet_ckpts")
    own = os.path.join(workdir, "resnet18-cli.pth")
    with open(pth, "rb") as src, open(own, "wb") as dst:
        dst.write(src.read())
    enc = torch.load(own, weights_only=True)
    with open(RESNET_CONFIG) as f:
        cfg = TrainConfig.from_dict(json.load(f))
    ds = NPZSequenceDataset(npz)
    n, t_seq = len(ds), ds.T
    del ds
    steps = int(cfg.train_frac * n) // cfg.batch_size
    evals = math.ceil((n - int(cfg.train_frac * n)) / cfg.batch_size)
    per_pass = sum(k for *_, k in resnet_k1_levels(
        THW, t_seq, cfg.model["lstm_layers"]))
    per_epoch = on_main_routes({
        "gate_update": (steps + evals) * per_pass,
        "gate_update_bwd": steps * per_pass, "conv3x3_fused": 0,
        **NO_LAUNCHES})
    last = os.path.join(ck, "resnet18_last.pt")
    runs = {}
    for tag, flags, n_epochs in (("train", [], 1),
                                 ("resume", ["--resume", last], 2)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = _cli(["train", "--config", RESNET_CONFIG, "--npz", npz, *flags,
                    f"checkpoint_dir={ck}", f"epochs={n_epochs}",
                    f"model.pretrained_path={own}"])
        state, meta = restore_checkpoint(last)
        runs[tag] = {"wall_s": time.perf_counter() - t0,
                     "launches": path_counts(), "expected": per_epoch,
                     "epoch_lines": [ln for ln in out.splitlines()
                                     if ln.startswith("Epoch ")],
                     "saved_model_config": meta["config"]["model"],
                     "encoder_equals_pth": _encoder_equal(state, enc)}
        if tag == "train":
            os.remove(own)            # the resume must not need it
    runs["resume"]["resumed_at_epoch_2"] = (
        f"resumed from {last} at epoch 2" in out)
    pred = StreamingPredictor(os.path.join(ck, "resnet18_best.pt"),
                              device=DEV)
    frame = np.ascontiguousarray(np.moveaxis(np.load(npz)["X"][:1, :1], 2,
                                             -1))
    sid = pred.open_session(1, THW, THW)
    torch.cuda.synchronize()
    reset_launches()
    y = pred.predict(sid, frame)
    serve = {"launches": path_counts(), "expected": on_main_routes(dict(
        NO_LAUNCHES, gate_update=sum(k for *_, k in resnet_k1_levels(
            THW, 1, cfg.model["lstm_layers"])), gate_update_bwd=0,
        conv3x3_fused=0)), "shape": list(y.shape),
        "finite": bool(np.isfinite(y).all())}
    del pred
    saved = runs["resume"]["saved_model_config"]
    ok = (all(r["launches"] == r["expected"] and r["encoder_equals_pth"]
              and len(r["epoch_lines"]) == 1 for r in runs.values())
          and runs["resume"]["resumed_at_epoch_2"]
          and runs["resume"]["epoch_lines"][0].startswith("Epoch 2/")
          and saved.get("pretrained_resolved") is True
          and "pretrained_path" not in saved
          and saved.get("freeze_encoder") is True
          and serve["launches"] == serve["expected"] and serve["finite"]
          and serve["shape"] == [1, 1, THW, THW, 1])
    emit({"phase": "resnet_cli", "config": os.path.relpath(RESNET_CONFIG,
                                                           ROOT),
          "samples": n, "B": cfg.batch_size, "T": t_seq, "H": THW,
          "train_steps_per_epoch": steps, "eval_batches_per_epoch": evals,
          "runs": runs, "serve": serve, "ok": ok})
    if not ok:
        raise AssertionError("resnet CLI run checks failed")
    return {k: runs["train"]["launches"][k] + runs["resume"]["launches"][k]
            for k in per_epoch}


def phase_resnet(workdir: str, npz: str):
    """The ResNet18 family: K1 forward and backward at its five levels on
    both paths, serving and latency, the training step, the CLI run."""
    layers = _resnet_cfg()["lstm_layers"]
    serve_levels = resnet_k1_levels(HW, T, layers)
    train_levels = resnet_k1_levels(RHW, RT, layers)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    k1 = {"serve": check_k1(gen, serve_levels, B, "request", "resnet"),
          "train": check_k1(gen, train_levels, RB, "step", "resnet")}
    k1_bwd = check_k1_bwd(gen, train_levels, RB, "resnet")
    pred, serve_counts, pth = resnet_serve(workdir)
    phase_latency(pred, prefix="resnet_")
    del pred
    torch.cuda.empty_cache()
    train_counts, per_step = resnet_train(pth)
    torch.cuda.empty_cache()
    cli_counts = resnet_cli(workdir, npz, pth)
    per_request = sum(n for *_, n in serve_levels)
    return {"gate_update": {
                "launches": serve_counts["gate_update"],
                "launches_per_request": per_request,
                "train_launches": train_counts["gate_update"],
                "launches_per_step": per_step,
                "cli_launches": cli_counts["gate_update"],
                "max_abs_err": max(k1["serve"]["max_abs_err"],
                                   k1["train"]["max_abs_err"]),
                **{k: k1["serve"][k] for k in ("ms", "plain_ms",
                                               "bound_ms")},
                "per": f"one resnet request: B={B}, T={T}, {HW}x{HW}, "
                       f"lstm_layers {layers}, bf16",
                "train": dict({k: k1["train"][k] for k in (
                    "ms", "plain_ms", "bound_ms")},
                    per=f"one resnet training step: B={RB}, T={RT}, "
                        f"{RHW}x{RHW}, bf16")},
            "gate_update_bwd": {
                "launches": train_counts["gate_update_bwd"],
                "launches_per_step": per_step,
                "cli_launches": cli_counts["gate_update_bwd"],
                **{k: k1_bwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms")},
                "per": f"one resnet training step: B={RB}, T={RT}, "
                       f"{RHW}x{RHW}, bf16"}}


# ---------------------------------------------------------------------------
# 12. evaluation and rollout
# ---------------------------------------------------------------------------

EVAL_CONFIG = os.path.join(ROOT, "configs", "cloud_wvu.json")
EN = 64                 # sequences in the seeded npz
SCAN_F32_TOL = 1e-6     # streaming against whole-sequence, RMS, f32
PREFIX_F32_TOL = 1e-5   # each prefix re-run's last frame against streaming:
#                         cuDNN's f32 convs over t frames against 1 frame
#                         may take other algorithms (TF32 off)


def _viz_available():
    """What the figures and the video need, by an import check."""
    return {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "cv2")}


def _load_pt(path):
    """A .pt checkpoint's model on the card, in eval mode, and its apply and
    init_state (the registry's)."""
    state, meta = restore_checkpoint(path)
    _, init, apply, init_state = build_model(dict(meta["config"].get(
        "model", meta["config"])))
    with torch.device("meta"):
        model = init()
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(DEV).eval(), apply, init_state, meta


def _profiled(fn):
    """Device time by kernel group of one ``fn()`` (after a warm call)."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_breakdown(prof, wall_ms)


def _seeded_npz(path, n, t, hw, c_out, seed):
    """X [n, t, 2, hw, hw] radiance-like (>= 0, some above the mask
    threshold), Y [n, t, c_out, hw, hw] velocity-like, from a seed."""
    rng = np.random.default_rng(seed)
    X = rng.gamma(2.0, 0.6, (n, t, 2, hw, hw)).astype(np.float32)
    Y = (rng.standard_normal((n, t, c_out, hw, hw)) * 5).astype(np.float32)
    np.savez(path, X=X, Y=Y)
    return path


def phase_eval(workdir: str, npz: str):
    """(a) ``evaluate`` through the CLI on phase 9's best checkpoint, (b)
    evaluate_model at cloud_wvu's width, (c) the three rollouts at base_ch
    64, 128x128, T=12, B=1 in f32, (d) ``rollout`` through the CLI.
    Returns (the bf16 evaluate's MAE, the launches of each part)."""
    viz = _viz_available()
    out = {}
    # (a) the CLI on the training run's best checkpoint: its MAE is the
    # best epoch's val MAE (the split replayed, the same batch and forward)
    ck = os.path.join(workdir, "ckpts")
    with open(os.path.join(ck, "history.csv"), newline="") as f:
        history = list(csv.DictReader(f))
    best = min(history, key=lambda r: float(r["val_loss"]))
    with open(FIT_CONFIG) as f:
        fit_cfg = TrainConfig.from_dict(json.load(f))
    ev_dir = os.path.join(workdir, "eval_out")
    evals = math.ceil((FIT_SAMPLES - int(fit_cfg.train_frac * FIT_SAMPLES))
                      / fit_cfg.batch_size)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    text = _cli(["evaluate", "--checkpoint", os.path.join(ck,
                                                          "custom_best.pt"),
                 "--npz", npz, "--out-dir", ev_dir, "--batch-size",
                 str(fit_cfg.batch_size)])
    wall = time.perf_counter() - t0
    counts = path_counts()
    expect = on_main_routes(dict(NO_LAUNCHES, gate_update=evals * K1_PER_STEP,
                                 gate_update_bwd=0,
                                 conv3x3_fused=evals * K2_PER_STEP))
    mae_line = next(ln for ln in text.splitlines() if ln.startswith("MAE="))
    printed = mae_line.split()[0][len("MAE="):]
    with open(os.path.join(ev_dir, "report.json")) as f:
        report = json.load(f)
    fields = {f.name for f in dataclasses.fields(EvalReport)}
    figures = (os.path.exists(os.path.join(ev_dir,
                                           "metrics_summary_grid.png"))
               if viz["matplotlib"] else
               "figures not drawn: matplotlib is not installed" in text)
    out["cli"] = {"printed": mae_line, "best_epoch": int(best["epoch"]),
                  "best_val_mae": float(best["val_mae"]),
                  "equal_to_4_decimals":
                      printed == f"{float(best['val_mae']):.4f}",
                  "report_fields_ok": set(report) == fields,
                  "figures": "drawn" if viz["matplotlib"] else
                  "not drawn: matplotlib is not installed",
                  "figures_ok": figures, "wall_s": wall,
                  "launches": counts, "expected": expect}
    bf16_mae = report["mae"]

    # (b) evaluate_model at cloud_wvu's width (base_ch 64, 3 channels)
    with open(EVAL_CONFIG) as f:
        wvu = json.load(f)
    model_cfg = dict(wvu["model"])
    wnpz = _seeded_npz(os.path.join(workdir, "wvu.npz"), EN, IT, HW,
                       model_cfg["out_channels"], SEED + 5)
    ds = NPZSequenceDataset(wnpz)
    _, init, apply, init_state = build_model(model_cfg)
    model = init(torch.Generator().manual_seed(SEED + 5), device=DEV)
    calibrate_bn(model, normalize_x(torch.from_numpy(
        ds.get_batch_raw(np.arange(2))[0]).to(DEV), ds.stats))
    wck = save_checkpoint(os.path.join(workdir, "wvu.pt"),
                          model.state_dict(), wvu, ds.stats.to_dict())
    del model
    model, apply, init_state, _ = _load_pt(wck)
    kern = functools.partial(apply, use_pallas=True,
                             use_fused_doubleconv=True)
    batches = EN // wvu["batch_size"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rep = evaluate_model(kern, model, ds, indices=np.arange(EN),
                         batch_size=wvu["batch_size"],
                         use_mask=wvu["use_mask"])
    wall = time.perf_counter() - t0
    counts = path_counts()
    per_fwd_k1 = sum(k for *_, k in k1_levels(BASE, HW, IT))
    expect = on_main_routes(dict(NO_LAUNCHES,
                                 gate_update=batches * per_fwd_k1,
                                 gate_update_bwd=0,
                                 conv3x3_fused=batches * K2_PER_REQUEST))
    out["evaluate_model"] = {
        "config": os.path.relpath(EVAL_CONFIG, ROOT), "sequences": EN,
        "B": wvu["batch_size"], "T": IT, "H": HW, "base_ch": BASE,
        "batches": batches, "wall_s": wall,
        "frames_per_s": EN * IT / wall, "mae": rep.mae, "rmse": rep.rmse,
        "bias": rep.bias, "err_std": rep.err_std, "n_pixels": rep.n_pixels,
        "mae_per_channel": rep.mae_per_channel.tolist(),
        "rmse_per_channel": rep.rmse_per_channel.tolist(),
        "bias_per_channel": rep.bias_per_channel.tolist(),
        "err_std_per_channel": rep.err_std_per_channel.tolist(),
        "finite": bool(np.isfinite([rep.mae, rep.rmse]).all()),
        "launches": counts, "expected": expect,
        "profile_one_batch": _profiled(lambda: evaluate_model(
            kern, model, ds, indices=np.arange(wvu["batch_size"]),
            batch_size=wvu["batch_size"], use_mask=wvu["use_mask"]))}

    # (c) the three rollouts, f32 (TF32 off), B=1, T=12
    x = normalize_x(torch.from_numpy(ds.get_batch_raw(np.arange(1))[0]).to(
        DEV), ds.stats)
    f32 = functools.partial(apply, policy=FP32_POLICY, use_pallas=True,
                            use_fused_doubleconv=True)
    roll = {}
    for name in ("streaming", "scan", "prefix"):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        if name == "streaming":
            y_s, st_s = rollout_streaming(f32, model, x, init_state)
        elif name == "scan":
            y_w, st_w = rollout_scan(f32, model, x, init_state)
        else:
            prefix = rollout_prefix_rerun(f32, model, x)
        torch.cuda.synchronize()
        roll[name] = {"wall_s": time.perf_counter() - t0,
                      "launches": path_counts()}
    frames_run = {"streaming": IT, "scan": IT, "prefix": IT * (IT + 1) // 2}
    forwards = {"streaming": IT, "scan": 1, "prefix": IT}
    for name, r in roll.items():
        r["expected"] = dict(NO_LAUNCHES, gate_update=3 * frames_run[name],
                             gate_update_bwd=0,
                             conv3x3_fused=K2_PER_REQUEST * forwards[name])
        r["launches"] = {k: r["launches"][k] for k in r["expected"]}
    leaves = [(a, b) for k in sorted(st_s) for hs, hw_ in zip(st_s[k],
                                                              st_w[k])
              for a, b in zip(hs, hw_)]
    roll["checks"] = {
        "scan_vs_streaming_rms": rms_rel_err(y_w, y_s),
        "final_state_rms": max(rms_rel_err(b, a) for a, b in leaves),
        "final_state_dtypes_equal": all(a.dtype == b.dtype
                                        for a, b in leaves),
        "prefix_last_frames_rms": max(rms_rel_err(p, y_s[:, t])
                                      for t, p in enumerate(prefix)),
        "tol": {"scan": SCAN_F32_TOL, "prefix": PREFIX_F32_TOL}}
    out["rollouts"] = roll
    del model

    # (d) rollout through the CLI on one sequence of the fit data
    video = os.path.join(workdir, "roll.mp4")
    torch.cuda.synchronize()
    reset_launches()
    text = _cli(["rollout", "--checkpoint", os.path.join(ck,
                                                         "custom_best.pt"),
                 "--npz", npz, "--sequence-idx", "0", "--out", video])
    counts = path_counts()
    with open(video[:-4] + "_frames.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    drawn = viz["matplotlib"] and viz["cv2"]
    out["rollout_cli"] = {
        "line": text.strip().splitlines()[-1], "frames": len(rows),
        "csv_finite": all(math.isfinite(float(r[k])) for r in rows
                          for k in ("mae", "rmse", "me")),
        "video": "drawn" if drawn else
        "not drawn: " + " and ".join(m for m, ok in viz.items() if not ok)
        + " not installed",
        "video_ok": (os.path.exists(video) and os.path.getsize(video) > 10_000)
        if drawn else "video not drawn" in text,
        "launches": counts,
        "expected": on_main_routes(dict(
            NO_LAUNCHES, gate_update=K1_PER_STEP, gate_update_bwd=0,
            conv3x3_fused=K2_PER_STEP))}
    c = out["cli"]
    ok = (c["equal_to_4_decimals"] and c["report_fields_ok"]
          and c["figures_ok"] and c["launches"] == c["expected"]
          and out["evaluate_model"]["finite"]
          and out["evaluate_model"]["launches"]
          == out["evaluate_model"]["expected"]
          and all(r["launches"] == r["expected"] for k, r in roll.items()
                  if k != "checks")
          and roll["checks"]["scan_vs_streaming_rms"] <= SCAN_F32_TOL
          and roll["checks"]["final_state_rms"] <= SCAN_F32_TOL
          and roll["checks"]["final_state_dtypes_equal"]
          and roll["checks"]["prefix_last_frames_rms"] <= PREFIX_F32_TOL
          and out["rollout_cli"]["frames"] == TT
          and out["rollout_cli"]["csv_finite"]
          and out["rollout_cli"]["video_ok"]
          and out["rollout_cli"]["launches"]
          == out["rollout_cli"]["expected"])
    emit({"phase": "eval", **out, "ok": ok})
    if not ok:
        raise AssertionError("evaluation / rollout checks failed")
    return bf16_mae, out


# ---------------------------------------------------------------------------
# 13. int8 post-training inference
# ---------------------------------------------------------------------------

INT8_REQUESTS = 50       # per predictor and geometry, for p50 / p90


def _forward_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn()`` ending in a synchronisation."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _request_latency(pred, b, t, rng):
    sid = pred.open_session(b, HW, HW)
    x = rng.gamma(2.0, 0.6, (b, t, HW, HW, 2)).astype(np.float32)
    for _ in range(3):
        pred.predict(sid, x)
    ms = []
    for _ in range(INT8_REQUESTS):
        t0 = time.perf_counter()
        pred.predict(sid, x)
        ms.append((time.perf_counter() - t0) * 1e3)
    pred.close_session(sid)
    return {"B": b, "T": t, "p50_ms": statistics.median(ms),
            "p90_ms": sorted(ms)[int(0.9 * len(ms)) - 1]}


def _http_round_trip(pred, x):
    server = serve_http(pred, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection(*server.server_address,
                                          timeout=300)
        _, body = _post(conn, "/v1/session", json.dumps(
            {"batch": x.shape[0], "height": HW, "width": HW}))
        sid = json.loads(body)["session_id"]
        xb = np.ascontiguousarray(x, "<f4")
        r, body = _post(conn, f"/v1/predict/{sid}", xb.tobytes(),
                        {"X-Shape": ",".join(map(str, xb.shape))})
        shape = tuple(int(v) for v in r.getheader("X-Shape").split(","))
        conn.close()
        return np.frombuffer(body, "<f4").reshape(shape)
    finally:
        server.shutdown()
        server.server_close()


def phase_int8(workdir: str, npz: str, bf16_mae: float, resnet_ckpt: str,
               smi: str):
    """The int8 path at scripts/perf/bench_int8.py's geometry (custom
    base_ch 64, 128x128, T=12, B=8): quantize_model of a seeded
    checkpoint, the launch counts of one forward, K8 against its plain
    version through the whole forward (f32), int8 against bf16,
    calibrate_tree, int8 serving (dynamic and calibrated, HTTP), forward
    time and request latency of int8 dynamic, int8 calibrated and bf16,
    ``evaluate --int8 --int8-calib 2`` through the CLI, and one int8
    request of the ResNet18 family."""
    rng = np.random.default_rng(SEED + 7)
    model_cfg = {"type": "custom", "base_ch": BASE}
    _, init, apply, _ = build_model(model_cfg)
    model = init(torch.Generator().manual_seed(SEED + 7), device=DEV)
    X = rng.gamma(2.0, 0.6, (IB, IT, HW, HW, 2)).astype(np.float32)
    Y = (rng.standard_normal((IB, IT, HW, HW, 1)) * 5).astype(np.float32)
    norm = compute_norm_stats(X, Y)
    xn = normalize_x(torch.from_numpy(X).to(DEV), norm)
    kern = functools.partial(apply, use_pallas=True,
                             use_fused_doubleconv=True)
    # the JAX test's condition: the model as initialised (BN at init)
    with torch.inference_mode():
        model.eval()
        fresh = rms_rel_err(kern(quantize_model(model), xn)[0],
                            kern(model, xn)[0])
    calibrate_bn(model, xn[:B, :T])
    ckpt = save_checkpoint(os.path.join(workdir, "int8.pt"),
                           model.state_dict(), model_cfg, norm.to_dict())
    del model
    pred_f = StreamingPredictor(ckpt, device=DEV)
    qmodel = quantize_model(pred_f.model)
    out = {"B": IB, "T": IT, "H": HW, "base_ch": BASE,
           "sites": len(quant_sites(qmodel)), "card": smi}

    # the main path: one bf16 int8 forward, launch counts around it
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launches()
        y8 = kern(qmodel, xn)[0]
        counts = k8_counts()
        per_k1 = sum(k for *_, k in k1_levels(BASE, HW, IT))
        expect = dict(on_main_routes(dict(NO_LAUNCHES, gate_update=per_k1,
                                          gate_update_bwd=0,
                                          conv3x3_fused=0)),
                      **k8_expect(K8_CUSTOM))
        out["main_path"] = {"launches": counts, "expected": expect}
        # K8 against its plain version through the whole forward (f32)
        y32 = kern(qmodel, xn, policy=FP32_POLICY)[0]
        with conv_int8.plain_reference():
            y32p = kern(qmodel, xn, policy=FP32_POLICY)[0]
            y8p = kern(qmodel, xn)[0]
        yf = kern(pred_f.model, xn)[0]
        out["checks"] = {
            "kernels_vs_plain_f32_rms": rms_rel_err(y32, y32p),
            "kernels_vs_plain_bf16_max_abs": float((y8.float()
                                                    - y8p.float()).abs()
                                                   .max()),
            "int8_vs_bf16_rel_l2_bn_at_init": fresh,
            "int8_vs_bf16_rel_l2": rms_rel_err(y8, yf),
            "finite": bool(torch.isfinite(y8).all())}
        del y32, y32p, y8p
    # calibrated static scales on 4 batches
    calib = [normalize_x(torch.from_numpy(rng.gamma(
        2.0, 0.6, (IB, IT, HW, HW, 2)).astype(np.float32)).to(DEV), norm)
        for _ in range(4)]
    t0 = time.perf_counter()
    cmodel = calibrate_tree(kern, qmodel, calib)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    scales = [m.x_s for m in quant_sites(cmodel).values()]
    with torch.inference_mode():
        reset_launches()
        yc = kern(cmodel, xn)[0]
        ccounts = k8_counts()
        out["calibrated"] = {
            "batches": len(calib), "wall_s": calib_s,
            "sites_with_scale": sum(s is not None for s in scales),
            "sites": len(scales), "launches": ccounts,
            "int8_vs_bf16_rel_l2": rms_rel_err(yc, yf),
            "finite": bool(torch.isfinite(yc).all())}
        # forward times, one call in turn each
        out["forward_ms"] = {
            name: _forward_ms(lambda m=m: kern(m, xn))
            for name, m in (("bf16", pred_f.model), ("int8_dynamic", qmodel),
                            ("int8_calibrated", cmodel))}
    del calib, cmodel, qmodel, yc, y8, yf
    torch.cuda.empty_cache()

    # serving: dynamic, and calibrated on frame blocks given as a generator
    pred8 = StreamingPredictor(ckpt, int8=True, device=DEV)
    blocks = (rng.gamma(2.0, 0.6, (B, T, HW, HW, 2)).astype(np.float32)
              for _ in range(4))
    pred8c = StreamingPredictor(ckpt, int8=True, device=DEV,
                                int8_calib_frames=blocks)
    frames = rng.gamma(2.0, 0.6, (B, T, HW, HW, 2)).astype(np.float32)
    serve = {}
    for name, p in (("int8_dynamic", pred8), ("int8_calibrated", pred8c)):
        sid = p.open_session(B, HW, HW)
        reset_launches()
        y = p.predict(sid, frames)
        serve[name] = {"launches": k8_counts(),
                       "finite": bool(np.isfinite(y).all()),
                       "http_rel_err": rel_err(torch.from_numpy(
                           _http_round_trip(p, frames).copy()),
                           torch.from_numpy(y))}
    serve["expected"] = k8_expect(k8_custom_convs(BASE, HW, B, T))
    serve["calib_blocks"] = pred8c.int8_calib_blocks
    out["serve"] = serve
    out["latency"] = {name: [_request_latency(p, b, t, rng)
                             for b, t in ((B, T), (1, 1))]
                      for name, p in (("bf16", pred_f),
                                      ("int8_dynamic", pred8),
                                      ("int8_calibrated", pred8c))}
    out["profile_one_request"] = {}
    for name, p in (("int8_dynamic", pred8), ("int8_calibrated", pred8c),
                    ("bf16", pred_f)):
        sid = p.open_session(B, HW, HW)
        out["profile_one_request"][name] = _profiled(
            lambda p=p, sid=sid: p.predict(sid, frames))
        p.close_session(sid)
    # the quantizer runs inside K8: a calibrated request launches no round
    # or two-sided clamp kernel beyond the bf16 request's
    quantizer = {name: prof["quantizer_like_calls"]
                 for name, prof in out["profile_one_request"].items()}
    out["quantizer_like_calls"] = quantizer
    del pred8, pred8c, pred_f
    torch.cuda.empty_cache()

    # evaluate --int8 --int8-calib 2 on the training run's checkpoint
    with open(FIT_CONFIG) as f:
        fit_cfg = TrainConfig.from_dict(json.load(f))
    text = _cli(["evaluate", "--checkpoint", os.path.join(
        workdir, "ckpts", "custom_best.pt"), "--npz", npz, "--out-dir",
        os.path.join(workdir, "eval_int8"), "--batch-size",
        str(fit_cfg.batch_size), "--int8", "--int8-calib", "2"])
    with open(os.path.join(workdir, "eval_int8", "report.json")) as f:
        mae8 = json.load(f)["mae"]
    # the same checkpoint dynamic int8 through evaluate_model, with K8 and
    # with its plain version: the card's int8 path exactly
    fmodel, fapply, _, fmeta = _load_pt(os.path.join(workdir, "ckpts",
                                                     "custom_best.pt"))
    fkern = functools.partial(fapply, use_pallas=True,
                              use_fused_doubleconv=True)
    fq = quantize_model(fmodel)
    fds = NPZSequenceDataset(npz, stats=NormStats.from_dict(
        fmeta["norm_stats"]))
    dyn = evaluate_model(fkern, fq, fds, batch_size=fit_cfg.batch_size,
                         use_mask=fit_cfg.use_mask)
    with conv_int8.plain_reference():
        dyn_plain = evaluate_model(fkern, fq, fds,
                                   batch_size=fit_cfg.batch_size,
                                   use_mask=fit_cfg.use_mask)
    del fmodel, fq, fds
    out["evaluate_int8"] = {
        "lines": [ln for ln in text.splitlines()
                  if ln.startswith(("MAE=", "int8:"))],
        "mae_calibrated_cli": mae8, "bf16_mae": bf16_mae,
        "calibrated_ratio": mae8 / bf16_mae,
        "rel_diff": abs(mae8 - bf16_mae) / bf16_mae,
        "mae_dynamic": dyn.mae, "dynamic_ratio": dyn.mae / bf16_mae,
        "mae_dynamic_plain_k8": dyn_plain.mae,
        "dynamic_kernel_vs_plain": abs(dyn.mae - dyn_plain.mae)
        / dyn_plain.mae}

    # one int8 request of the ResNet18 family (stem, stride 2, 1x1)
    pr8 = StreamingPredictor(resnet_ckpt, int8=True, device=DEV)
    prf = StreamingPredictor(resnet_ckpt, device=DEV)
    sid, sidf = pr8.open_session(B, HW, HW), prf.open_session(B, HW, HW)
    reset_launches()
    y = pr8.predict(sid, frames)
    rcounts = k8_counts()
    yf = prf.predict(sidf, frames)
    r_k1 = sum(k for *_, k in resnet_k1_levels(HW, T, 2))
    out["resnet"] = {
        "launches": rcounts,
        "expected": dict(gate_update=r_k1, conv3x3_fused=0,
                         **k8_expect(K8_RESNET)),
        "finite": bool(np.isfinite(y).all()),
        "int8_vs_bf16_rel_l2": float(np.linalg.norm(y - yf)
                                     / np.linalg.norm(yf))}
    del pr8, prf

    c = out["checks"]
    ok = (counts == expect and c["finite"]
          and c["kernels_vs_plain_f32_rms"] <= INT8_PLAIN_TOL
          and c["kernels_vs_plain_bf16_max_abs"] == 0.0
          and c["int8_vs_bf16_rel_l2_bn_at_init"] < INT8_PTQ_BOUND
          and out["calibrated"]["sites_with_scale"]
          == out["calibrated"]["sites"] == out["sites"]
          and out["calibrated"]["finite"]
          and all(out["calibrated"]["launches"][k] == v
                  for k, v in k8_expect(K8_CUSTOM).items())
          and out["calibrated"]["launches"]["conv3x3_fused"] == 0
          and all(all(serve[n]["launches"][k] == v
                      for k, v in serve["expected"].items())
                  and serve[n]["launches"]["gate_update"] == 3 * T
                  and serve[n]["launches"]["conv3x3_fused"] == 0
                  and serve[n]["finite"] and serve[n]["http_rel_err"] <= 1e-6
                  for n in ("int8_dynamic", "int8_calibrated"))
          and serve["calib_blocks"] == 4
          and quantizer["int8_calibrated"] <= quantizer["bf16"]
          and math.isfinite(out["evaluate_int8"]["mae_calibrated_cli"])
          and out["evaluate_int8"]["calibrated_ratio"] <= INT8_EVAL_SANITY
          and out["evaluate_int8"]["dynamic_kernel_vs_plain"] <= 1e-6
          and all(rcounts[k] == v for k, v in
                  out["resnet"]["expected"].items())
          and out["resnet"]["finite"])
    emit({"phase": "int8", **out, "ok": ok})
    if not ok:
        raise AssertionError("int8 checks failed")
    return counts


# ---------------------------------------------------------------------------
# 14. the data chain
# ---------------------------------------------------------------------------

MICRO_SHAPE = (64, 128, 128)     # a BOMEX-like block [Z, Y, X] at 20 m
MICRO_TOL = 1e-5
MICRO_TOL_WHY = ("f32 on the card against float64 numpy, elementwise "
                 "relative: the inputs' f32 rounding and ~12 f32 ops, powf "
                 "and the f32 exponent 1/3 move each output by a few 1e-7")
GATE = cloud_gate.PRODUCTION
# stage C at the production geometry: the gate's patches (128x128x32 at
# 20 m), 256x256, the slice mid-cloud at the gate's height
C_SLICE_M = int(GATE.nz * GATE.voxel_size * 0.5)
C_BATCH = 8
C_TOL = 1e-3
C_TOL_WHY = ("share of pixels whose NaN-ness or value differs between the "
             "card and the CPU: a value is a voxel's, so the maps agree "
             "exactly where both pick the same voxel; at 600 km an ulp of a "
             "ray direction (rounded otherwise by the card's kernels) moves "
             "an off-nadir ray's sample by ~0.02 m, which may cross a voxel "
             "face or a cloud edge")
MC_CHAIN = dataclasses.replace(
    cloud_gate.CloudGateConfig(), nz=8, nxy=16, n_folders=2, n_samples=4,
    render_res=16, out_size=16, base_ch=4, epochs=1, batch_size=2,
    mc_spp=4, mc_majorant_cell=16, mae_threshold=float("inf"))


def check_microphysics():
    """``process_cloud_vars`` on f32 tensors on the card against float64
    numpy at a BOMEX-like block (p in mb, T 290-300 K, QN up to 1 g/kg)."""
    rng = np.random.default_rng(SEED)
    nz, ny, nx = MICRO_SHAPE
    z_m = np.arange(nz) * 20.0
    p = 1015.0 * np.exp(-z_m / 8500.0)
    t = (299.0 - 6.5e-3 * z_m[:, None, None]
         + rng.uniform(-1.0, 1.0, MICRO_SHAPE))
    qn = np.minimum(rng.gamma(0.5, 0.3, MICRO_SHAPE), 1.0) * (
        rng.random(MICRO_SHAPE) < 0.3)
    nc = rng.uniform(40.0, 80.0, MICRO_SHAPE)
    want = process_cloud_vars(qn, nc, t, p)
    got = process_cloud_vars(*(torch.tensor(a, dtype=torch.float32,
                                            device=DEV)
                               for a in (qn, nc, t)), p)
    errs = {}
    for name, g, w in zip(("lwc", "reff_um", "beta_ext"), got, want):
        g = g.double().cpu().numpy()
        errs[name] = float(np.max(np.abs(g - w) / np.maximum(np.abs(w),
                                                             1e-30)))
    ok = (all(e <= MICRO_TOL for e in errs.values())
          and all(g.dtype == torch.float32 and g.device.type == "cuda"
                  for g in got))
    emit({"phase": "microphysics", "shape": list(MICRO_SHAPE),
          "t_range_k": [float(t.min()), float(t.max())],
          "qn_max_g_kg": float(qn.max()), "cloudy_share":
          float((qn > 0).mean()), "max_rel_err": errs, "tol": MICRO_TOL,
          "tol_why": MICRO_TOL_WHY, "ok": ok})
    if not ok:
        raise AssertionError("microphysics on the card disagrees")


def _maps(root):
    """{relative path: {'u_map', 'v_map', 'w_map'}} of a gen-maps tree."""
    return {k: d for k, (_, d) in _pkls(root).items()}


def _maps_diff(a, b):
    """Pixels of two map trees whose NaN-ness or value differs."""
    px = diff = 0
    for key in a:
        for m in ("u_map", "v_map", "w_map"):
            x, y = a[key][m], b[key][m]
            same = (np.isnan(x) & np.isnan(y)) | (x == y)
            px += x.size
            diff += int((~same).sum())
    return diff, px


def _gen_maps(args, dst, device=None):
    """``gen-maps`` through the CLI: wall seconds, launch counts."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        cli_main(["gen-maps", *args, "--output", dst]
                 + (["--device", device] if device else []))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, launch_counts()


def check_stage_c(workdir: str):
    """gen-maps on the gate's production patches (one time folder of 8)
    and a 2-view overpass CSV, each mode: serial and --batch 8 on the card
    (each twice; the faster run timed), the same call on the CPU; then the
    CSV's own (off-nadir) cameras on the card and the CPU."""
    root = os.path.join(workdir, "c_patches")
    cloud_gate.synthesize_cloud_patches(
        root, dataclasses.replace(GATE, n_folders=1))
    csv_path = synthesize_overpass_csv(
        os.path.join(workdir, "c_overpass.csv"), n_times=1, n_satellites=2)
    base = ["--input", root, "--csv", csv_path, "--res", "256",
            "--slice-height", str(C_SLICE_M)]
    ok = True
    for mode in ("slice", "first_hit"):
        runs, walls, counts = {}, {}, {}
        for tag, extra, dev in (
                ("card", [], None), ("card_batch", ["--batch", str(C_BATCH)],
                                     None),
                ("cpu", [], "cpu"), ("card_csv", ["--csv-cameras"], None),
                ("cpu_csv", ["--csv-cameras"], "cpu")):
            reps = 2 if dev is None and tag in ("card", "card_batch") else 1
            for r in range(reps):
                dst = os.path.join(workdir, f"c_{mode}_{tag}_{r}")
                wall, counts[tag] = _gen_maps(base + ["--mode", mode] + extra,
                                              dst, dev)
                walls.setdefault(tag, []).append(wall)
            runs[tag] = _maps(dst)
        n = len(runs["card"])
        card_cpu = _maps_diff(runs["card"], runs["cpu"])
        card_cpu_csv = _maps_diff(runs["card_csv"], runs["cpu_csv"])
        batch_equal = _maps_diff(runs["card_batch"], runs["card"])[0] == 0
        nan_share = float(np.mean([np.isnan(d["w_map"]).mean()
                                   for d in runs["card"].values()]))
        finite_somewhere = all(np.isfinite(d["w_map"]).any()
                               for d in runs["card"].values())
        line = {
            "phase": "stage_c", "mode": mode, "patch": [GATE.nz, GATE.nxy,
                                                        GATE.nxy],
            "voxel_m": GATE.voxel_size, "res": 256, "pkls": n,
            "views": 2, "slice_height_m": C_SLICE_M,
            "ms_per_patch": {k: 1e3 * min(v) / (n // 2)
                             for k, v in walls.items()},
            "walls_s": walls, "launches": counts,
            "batched_equal_serial": batch_equal,
            "card_vs_cpu_pixels_differing": card_cpu[0],
            "card_vs_cpu_csv_cameras_pixels_differing": card_cpu_csv[0],
            "pixels": card_cpu[1], "nan_share": nan_share,
            "tol": C_TOL, "tol_why": C_TOL_WHY}
        line["ok"] = (n == 2 * GATE.n_samples and batch_equal
                      and card_cpu[0] <= C_TOL * card_cpu[1]
                      and card_cpu_csv[0] <= C_TOL * card_cpu_csv[1]
                      and finite_somewhere
                      and all(sum(c.values()) == 0 for c in counts.values()))
        emit(line)
        ok = ok and line["ok"]
    if not ok:
        raise AssertionError("stage C checks failed")


def _gate_expect(npz: str, cfg, epochs: int):
    """The gate's fit launches: per pass k1_levels and k2_convs of its
    model at T = seq_len, over the train steps and eval batches of each
    epoch that ran."""
    ds = NPZSequenceDataset(npz)
    tr, va = ds.train_val_split(0.8, 42)
    steps = len(tr) // cfg.batch_size
    evals = math.ceil(len(va) / cfg.batch_size)
    k1 = sum(n for *_, n in k1_levels(cfg.base_ch, cfg.out_size,
                                       cfg.seq_len))
    k2 = sum(n for *_, n in k2_convs(cfg.base_ch, cfg.out_size))
    return {"gate_update": (steps + evals) * k1 * epochs,
            "gate_update_bwd": steps * k1 * epochs,
            "conv3x3_fused": (steps + evals) * k2 * epochs}, steps, evals


def gate_production(workdir: str):
    """``cloud-gate --production`` through the CLI on the card; the gate
    must print PASSED and exit 0, its fit's launches exact."""
    work = os.path.join(workdir, "gate")
    out_json = os.path.join(workdir, "gate.json")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(["cloud-gate", "--work-dir", work, "--production",
                      "--out", out_json])
            code = None
        except SystemExit as e:       # the gate's verdict, 0 or 1
            code = e.code
    wall = time.perf_counter() - t0
    counts = path_counts()
    sys.stderr.write(buf.getvalue())
    with open(out_json) as f:
        res = json.load(f)
    with open(os.path.join(work, "gate_dataset.json")) as f:
        npz = json.load(f)["npz"]
    epochs = len(res["history"])
    fit, steps, evals = _gate_expect(npz, GATE, epochs)
    expect = on_main_routes(dict(NO_LAUNCHES, **fit))
    verdict = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("[cloud-gate] val MAE")]
    line = {"phase": "cloud_gate", "config": "PRODUCTION",
            "geometry": {"patch": [GATE.nz, GATE.nxy, GATE.nxy],
                         "render": GATE.render_res, "out": GATE.out_size,
                         "base_ch": GATE.base_ch, "T": GATE.seq_len,
                         "B": GATE.batch_size, "epochs": GATE.epochs,
                         "sequences": GATE.n_samples
                         * (GATE.n_folders // GATE.seq_len)},
            "exit_code": code, "verdict": verdict, "passed": res["passed"],
            "best_val_mae": res["best_val_mae"],
            "first_epoch_val_mae": res["first_epoch_val_mae"],
            "final_val_mae": res["final_val_mae"],
            "best_epoch": res["best_epoch"],
            "mae_threshold": res["mae_threshold"],
            "stage_s": res["stage_s"], "wall_s": wall,
            "epochs_run": epochs, "train_steps_per_epoch": steps,
            "eval_batches_per_epoch": evals, "launches": counts,
            "expected": expect,
            "from_nc": ("not run: --from-nc writes its .nc files with h5py "
                        "and reads them with netCDF4 or h5py (importable "
                        "here: h5py "
                        f"{importlib.util.find_spec('h5py') is not None}, "
                        "netCDF4 "
                        f"{importlib.util.find_spec('netCDF4') is not None}"
                        "); stage A is held against the JAX package on the "
                        "CPU by tests/test_torch_datagen_stage_a.py and "
                        "tests/test_torch_cloud_gate.py")}
    line["ok"] = (code == 0 and res["passed"]
                  and res["best_val_mae"] < GATE.mae_threshold
                  and res["best_val_mae"] < res["first_epoch_val_mae"]
                  and len(verdict) == 1 and verdict[0].endswith("PASSED")
                  and counts == expect)
    emit(line)
    if not line["ok"]:
        raise AssertionError("the production cloud gate failed")
    return counts, res


def gate_mc_chain(workdir: str):
    """The gate with stage B on the Monte-Carlo path tracer at a reduced
    size: stages C and D must consume the MC renders. Its MAE is not
    judged at this size."""
    cfg = MC_CHAIN
    work = os.path.join(workdir, "gate_mc")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = cloud_gate.run_cloud_gate(work, cfg, device=DEV)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    npz = np.load(os.path.join(work, "cloud_w.npz"))
    folder = sorted(os.listdir(os.path.join(work, "renders")))[0]
    renders = {}
    for v in (0, 1):
        with open(os.path.join(work, "renders", folder,
                               f"sample_000_time_0_view_{v}.pkl"), "rb") as f:
            renders[v] = pickle.load(f)["render"]
    consumed = all(np.array_equal(npz["X"][0, 0, v], renders[v])
                   for v in (0, 1))
    fit, _, _ = _gate_expect(os.path.join(work, "cloud_w.npz"), cfg,
                             len(res["history"]))
    line = {"phase": "mc_chain", "mc_spp": cfg.mc_spp,
            "mc_majorant_cell": cfg.mc_majorant_cell,
            "geometry": [cfg.nz, cfg.nxy, cfg.nxy, cfg.n_folders,
                         cfg.n_samples], "stage_s": res["stage_s"],
            "wall_s": wall, "launches": counts,
            "sequences": list(npz["X"].shape),
            "renders_reach_the_npz": consumed,
            "renders_finite_nonnegative": all(
                np.isfinite(r).all() and (r >= 0).all()
                for r in renders.values()),
            "val_mae": [h["val_mae"] for h in res["history"]
                        if "val_mae" in h],
            "mc_sample_flights": ("0 by design: stage B's Monte-Carlo "
                                  "route (render_dataset, as in the JAX "
                                  "package) draws threefry uniforms and "
                                  "has no fused-sampler option")}
    line["ok"] = (consumed and line["renders_finite_nonnegative"]
                  and counts["mc_sample_flights"] == 0
                  and counts["gate_update"] == fit["gate_update"]
                  and counts["gate_update_bwd"] == fit["gate_update_bwd"]
                  and all(math.isfinite(m) for m in line["val_mae"]))
    emit(line)
    if not line["ok"]:
        raise AssertionError("the MC chain failed")


def phase_datachain(workdir: str):
    """Stage A's microphysics, stage C at production geometry, the
    production gate, the reduced MC chain. Returns the gate's launch
    counts and its result."""
    check_microphysics()
    check_stage_c(workdir)
    counts, gate = gate_production(workdir)
    gate_mc_chain(workdir)
    return counts, gate


# ---------------------------------------------------------------------------
# 15. the rest of the single-card surface
# ---------------------------------------------------------------------------

SURFACE_B, SURFACE_T = 16, 12     # one cloud batch at 128x128
GATHER_REPS = 10                  # timed batches per gather route
SURFACE_EVAL_TOL = 1e-6
SURFACE_TOL = ("native gather bit-equal to numpy's two passes; gen-mnist "
               "byte-equal to the numpy paste; the loader's epochs each "
               "cover every train index once and each batch equals "
               "get_batch_raw of its indices; the convert-checkpoint round "
               "trip bit-equal; the --quantize copy's evaluate MAE within "
               f"{SURFACE_EVAL_TOL} of evaluate --int8 (the same int8 "
               "weights, dynamic scales both ways), its launches exact; "
               "stats equal to numpy's; doctor exit 0, every line PASS; viz "
               "numbers equal to numpy's, every drawing not drawn says so")


def _take(total):
    """The launch counts since the last reset, added into ``total``; the
    counts are then reset."""
    torch.cuda.synchronize()
    counts = k8_counts()
    total.update(counts)
    reset_launches()
    return counts


def _gather_case(name, src, idx):
    """One batch through both routes of gather_transpose: bit-equal, the
    native route taken, each route's host ms a batch (median)."""
    before = fast_gather.calls_by_route["native"]
    native = fast_gather.gather_transpose(src, idx)
    took_native = fast_gather.calls_by_route["native"] == before + 1
    equal = bool(np.array_equal(native,
                                fast_gather.gather_transpose_plain(src,
                                                                   idx)))
    ms = {}
    for route, fn in (
            ("native", fast_gather.gather_transpose),
            ("native_1thread", functools.partial(fast_gather.gather_transpose,
                                                 nthreads=1)),
            ("numpy", fast_gather.gather_transpose_plain)):
        ts = []
        for _ in range(GATHER_REPS):
            t0 = time.perf_counter()
            fn(src, idx)
            ts.append((time.perf_counter() - t0) * 1e3)
        ms[route] = statistics.median(ts)
    return {"case": name, "src": list(src.shape), "batch": len(idx),
            "bytes_out": native.nbytes, "bit_equal": equal,
            "native_route": took_native, "native_host_ms": ms["native"],
            "native_1thread_host_ms": ms["native_1thread"],
            "numpy_host_ms": ms["numpy"],
            "numpy_over_native": ms["numpy"] / ms["native"]}


def surface_gather(npz, cfg):
    """The native gather at the fit phase's batch and at one cloud batch
    of configs/cloud_wvu.json's channel counts (B=16, T=12, 128x128)."""
    ds = NPZSequenceDataset(npz)
    idx = np.sort(ds.train_val_split(cfg.train_frac,
                                     cfg.split_seed)[0][:cfg.batch_size])
    with open(EVAL_CONFIG) as f:
        wvu = json.load(f)["model"]
    rng = np.random.default_rng(SEED)
    n = 2 * SURFACE_B
    cidx = np.sort(rng.choice(n, SURFACE_B, replace=False))
    cases = [_gather_case("fit_x", ds.X, idx), _gather_case("fit_y", ds.Y,
                                                            idx)]
    for name, c in (("cloud_x", 2 * wvu.get("in_channels_per_sat", 1)),
                    ("cloud_y", wvu.get("out_channels", 1))):
        src = rng.standard_normal((n, SURFACE_T, c, HW, HW),
                                  dtype=np.float32)
        cases.append(_gather_case(name, src, cidx))
        del src
    line = {"phase": "surface", "check": "native_gather",
            "gpp_build_s_first_use": host_build.built_in_s,
            "library": str(host_build.build_dir() / "libhostio.so"),
            "host_cpus": os.cpu_count(),
            "host_cpus_usable": len(os.sched_getaffinity(0)),
            "threads": fast_gather._NTHREADS,
            "times": "host ms a batch on the card machine's CPU, median of "
                     f"{GATHER_REPS}",
            "cases": cases,
            "ok": all(c["bit_equal"] and c["native_route"] for c in cases)}
    emit(line)
    return line


def surface_gen_mnist(npz):
    """gen-mnist's npz (phase 9, the native paste) against the generator
    with the numpy paste at the same size and seed."""
    t0 = time.perf_counter()
    native_paste = moving_mnist.paste_digit
    moving_mnist.paste_digit = moving_mnist.paste_digit_plain
    try:
        X, Y = moving_mnist.moving_mnist_to_xy(
            moving_mnist.generate_moving_mnist(TT, FIT_SAMPLES, THW, 2,
                                               seed=SEED))
    finally:
        moving_mnist.paste_digit = native_paste
    plain_s = time.perf_counter() - t0
    data = np.load(npz)
    equal = (X.tobytes() == data["X"].tobytes()
             and Y.tobytes() == data["Y"].tobytes())
    line = {"phase": "surface", "check": "gen_mnist", "samples": FIT_SAMPLES,
            "T": TT, "H": THW, "byte_equal_to_numpy_paste": equal,
            "numpy_paste_generate_s": plain_s, "ok": equal}
    emit(line)
    return line


def surface_loader(npz, cfg):
    """make_grain_loader at worker_count 0 and 2, shuffled, 2 epochs over
    the fit phase's train split."""
    from unet_convlstm_tpu_torch.data.pipeline import (_EpochSampler,
                                                      make_grain_loader)

    # mmap=True writes the .npy sidecars once, before the workers map them
    ds = NPZSequenceDataset(npz, mmap=True)
    tr = np.asarray(ds.train_val_split(cfg.train_frac, cfg.split_seed)[0])
    epochs, n = 2, len(tr)
    order = tr[list(_EpochSampler(n, True, cfg.seed, epochs))]
    covered = all(sorted(order[e * n:(e + 1) * n]) == sorted(tr)
                  for e in range(epochs))
    runs = []
    for workers in (0, 2):
        t0 = time.perf_counter()
        batches = list(make_grain_loader(ds, tr, cfg.batch_size,
                                         shuffle=True, seed=cfg.seed,
                                         worker_count=workers,
                                         num_epochs=epochs))
        wall = time.perf_counter() - t0
        pos, equal = 0, True
        for x, y in batches:
            xr, yr = ds.get_batch_raw(order[pos:pos + len(x)])
            equal = equal and np.array_equal(x, xr) and np.array_equal(y, yr)
            pos += len(x)
        runs.append({"worker_count": workers, "batches": len(batches),
                     "samples": pos, "batches_equal_get_batch_raw": equal,
                     "wall_s": wall,
                     "host_ms_per_batch": wall / len(batches) * 1e3})
        del batches
    ok = covered and all(r["batches_equal_get_batch_raw"]
                         and r["samples"] == epochs * n for r in runs)
    line = {"phase": "surface", "check": "grain_loader", "epochs": epochs,
            "train_indices": n, "B": cfg.batch_size,
            "each_epoch_covers_every_index_once": covered, "runs": runs,
            "ok": ok}
    emit(line)
    return line


def surface_convert(workdir, npz, cfg, total):
    """convert-checkpoint --to-torch then --torch-ckpt of the fit phase's
    best checkpoint; --quantize, then evaluate of the int8 copy against
    evaluate --int8 of the float checkpoint, the copy's launches exact."""
    ck = os.path.join(workdir, "ckpts", "custom_best.pt")
    ref = os.path.join(workdir, "surface_ref.pt")
    conv = os.path.join(workdir, "surface_conv")
    _cli(["convert-checkpoint", "--checkpoint", ck, "--to-torch", ref])
    _cli(["convert-checkpoint", "--torch-ckpt", ref, "--out-dir", conv])
    state, meta = restore_checkpoint(ck)
    back, bmeta = restore_checkpoint(os.path.join(conv,
                                                  "custom_converted.pt"))
    bit_equal = (state.keys() == back.keys()
                 and all(torch.equal(state[k], back[k]) for k in state))
    model_cfg = meta["config"].get("model", meta["config"])
    # Moving-MNIST: X has 2 channels (one a satellite), Y 1
    want_cfg = {**{k: model_cfg[k] for k in ("base_ch", "lstm_layers",
                                             "use_skip_lstm",
                                             "use_attention")},
                "in_channels_per_sat": 1, "out_channels": 1}
    got_cfg = {k: bmeta["config"].get(k) for k in want_cfg}

    q = os.path.join(workdir, "surface_int8.pt")
    _cli(["convert-checkpoint", "--checkpoint", ck, "--quantize", q])
    _, qmeta = restore_checkpoint(q)
    evals = math.ceil((FIT_SAMPLES - int(cfg.train_frac * FIT_SAMPLES))
                      / cfg.batch_size)
    per_pass = [(*c[:-1], c[-1] * evals) for c in k8_custom_convs(
        cfg.model["base_ch"], THW, cfg.batch_size, TT)]
    expect = dict(on_main_routes(dict(NO_LAUNCHES,
                                      gate_update=evals * K1_PER_STEP,
                                      gate_update_bwd=0, conv3x3_fused=0)),
                  **k8_expect(per_pass))
    maes, counts = {}, {}
    for tag, argv in (("int8_copy", ["--checkpoint", q]),
                      ("int8_flag", ["--checkpoint", ck, "--int8"])):
        _take(total)
        out_dir = os.path.join(workdir, f"surface_eval_{tag}")
        _cli(["evaluate", *argv, "--npz", npz, "--out-dir", out_dir,
              "--batch-size", str(cfg.batch_size)])
        counts[tag] = _take(total)
        with open(os.path.join(out_dir, "report.json")) as f:
            maes[tag] = json.load(f)["mae"]
    diff = abs(maes["int8_copy"] - maes["int8_flag"])
    # one request served from the int8 copy, no --int8 flag
    pred = StreamingPredictor(q, device=DEV)
    frame = NPZSequenceDataset(npz, mmap=True).get_batch_raw(
        np.array([0]))[0][:, :1]
    sid = pred.open_session(1, THW, THW)
    _take(total)
    y = pred.predict(sid, frame)
    serve = {"int8": pred.int8, "launches": _take(total),
             "expected": dict(on_main_routes(dict(
                 NO_LAUNCHES, gate_update=sum(n for *_, n in k1_levels(
                     cfg.model["base_ch"], THW, 1)),
                 gate_update_bwd=0, conv3x3_fused=0)), **k8_expect(
                     k8_custom_convs(cfg.model["base_ch"], THW, 1, 1))),
             "finite": bool(np.isfinite(y).all())}
    del pred
    line = {"phase": "surface", "check": "convert_checkpoint",
            "round_trip_model_state_bit_equal": bit_equal,
            "inferred_config": got_cfg, "training_config": want_cfg,
            "int8_meta": bool(qmeta.get("int8")),
            "evaluate_mae": maes, "mae_abs_diff": diff,
            "tol": SURFACE_EVAL_TOL, "eval_batches": evals,
            "launches_int8_copy": counts["int8_copy"],
            "launches_int8_flag": counts["int8_flag"], "expected": expect,
            "serve_int8_copy": serve,
            "ok": (bit_equal and got_cfg == want_cfg and qmeta.get("int8")
                   is True and diff <= SURFACE_EVAL_TOL
                   and counts["int8_copy"] == expect
                   and counts["int8_flag"] == expect and serve["int8"]
                   and serve["launches"] == serve["expected"]
                   and serve["finite"])}
    emit(line)
    return line


def _one_pkl(root):
    hits = sorted(glob.glob(os.path.join(root, "*", "*.pkl")))
    if not hits:
        raise AssertionError(f"no pkl under {root}")
    return hits[0]


def surface_stats_inspect(workdir, npz, gate):
    """``stats`` on the fit phase's npz against numpy; ``inspect`` on a
    stage-B render and a stage-C map of phase 14's gate, and on an .nc."""
    stats = json.loads(_cli(["stats", "--npz", npz]))
    Y = np.load(npz)["Y"]
    nz = Y[Y != 0]
    want = {"min": float(Y.min()), "max": float(Y.max()),
            "nonzero_fraction": float((Y != 0).mean()),
            "nonzero_mean": float(nz.mean()) if nz.size else 0.0}
    del Y, nz
    inspected = {}
    for stage in ("renders", "maps"):
        path = _one_pkl(os.path.join(gate, stage))
        desc = json.loads(_cli(["inspect", path]))
        with open(path, "rb") as f:
            raw = pickle.load(f)
        inspected[stage] = {
            "path": os.path.relpath(path, gate), "json": desc,
            "ok": desc.keys() == raw.keys() and all(
                desc[k]["shape"] == list(v.shape) for k, v in raw.items()
                if isinstance(v, np.ndarray))}
    nc = os.path.join(workdir, "surface.nc")
    readers = [m for m in ("netCDF4", "h5py")
               if importlib.util.find_spec(m) is not None]
    if readers:
        import h5py   # the CLI reads it with either; h5py writes it here

        with h5py.File(nc, "w") as f:
            f["z"] = np.arange(4.0)
        nc_line = json.loads(_cli(["inspect", nc]))
        nc_ok = nc_line["z"]["shape"] == [4]
    else:
        with open(nc, "wb") as f:
            f.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
        try:
            _cli(["inspect", nc])
            nc_line, nc_ok = "no error", False
        except ImportError as e:
            nc_line = (f"ImportError: {e} (this machine has neither netCDF4 "
                       "nor h5py, so .nc files cannot be read here)")
            nc_ok = "neither netCDF4 nor h5py" in str(e)
    line = {"phase": "surface", "check": "stats_inspect", "stats": stats,
            "numpy": want, "inspect": inspected, "nc": nc_line,
            "ok": (stats == want and nc_ok
                   and all(v["ok"] for v in inspected.values()))}
    emit(line)
    return line


def surface_doctor(proc, t0):
    """``doctor`` as a user runs it (``proc``, started at ``t0`` while the
    other checks ran): exit 0, every line PASS, each CUDA source and the
    host kernels listed."""
    stdout, stderr = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[")]
    listed = {src.name: any(f"kernel source {src.name}" in ln
                            for ln in lines)
              for src in build.sources().values()}
    ok = (proc.returncode == 0 and bool(lines)
          and all(ln.startswith("[PASS]") for ln in lines)
          and all(listed.values())
          and any("native hostio" in ln for ln in lines))
    line = {"phase": "surface", "check": "doctor", "rc": proc.returncode,
            "lines": stdout.splitlines(), "sources_listed": listed,
            "wall_s": wall, "stderr_tail": stderr[-2000:], "ok": ok}
    emit(line)
    return line


def surface_viz(workdir, npz, gate):
    """Each ported viz module on this machine: its numbers against numpy,
    and each drawing call drawn or saying what it did not draw."""
    from unet_convlstm_tpu_torch.viz import (checks, dashboard3d,
                                             legacy_viewer, sequences_video,
                                             viewers)

    avail = _viz_available()
    vdir = os.path.join(workdir, "surface_viz")
    os.makedirs(vdir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    u, v, w = rng.standard_normal((3, 16, 64, 64))
    beta = np.zeros((16, 64, 64))
    beta[4:9, 20:40, 20:40] = 0.1
    render_pkl = _one_pkl(os.path.join(gate, "renders"))
    map_pkl = _one_pkl(os.path.join(gate, "maps"))
    with open(render_pkl, "rb") as f:
        render = pickle.load(f)["render"]
    with open(map_pkl, "rb") as f:
        maps = pickle.load(f)
    legacy = os.path.join(vdir, "legacy")
    os.makedirs(legacy)
    for t in range(3):
        with open(os.path.join(legacy, f"sample_{t}_3_7.pkl"), "wb") as f:
            pickle.dump({"tensors": rng.random((1, 3, 16, 16)),
                         "target_slice": rng.random((9, 1, 16, 16))}, f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        div = checks.divergence_check(u, v, w, beta, 20.0, vdir)
        spot = checks.spot_check_maps(map_pkl, render_pkl, vdir)
        drawn = {
            "volume figure": checks.volume_check(
                beta, os.path.join(vdir, "vol.png")),
            "Moving-MNIST video": viewers.moving_mnist_video(
                npz, os.path.join(vdir, "mm.mp4"), sample_idx=0),
            "sample panel": viewers.show_sample_panel(
                npz, os.path.join(vdir, "panel.png")),
            "mask-tuning video": sequences_video.create_mask_tuning_video(
                rng.random((3, 2, 32, 32)) * 3,
                os.path.join(vdir, "mask.mp4")),
            "legacy sequence video": legacy_viewer.animate_sequence(
                legacy_viewer.PKLSequenceDataset(legacy, 2, 1), 0,
                os.path.join(vdir, "legacy.mp4")),
            "dashboard frame": dashboard3d.compose_dashboard_frame(
                [render, render], [maps["w_map"], None],
                np.zeros((40, 30, 3), np.uint8)),
            "dashboard video": dashboard3d.create_dashboard_3d(
                os.path.join(gate, "renders"), os.path.join(gate, "maps"),
                os.path.join(gate, "overpass.csv"), 0,
                os.path.join(vdir, "dash.mp4"), verbose=False) or None,
        }
    said = buf.getvalue()
    needs = {"divergence figures": ("matplotlib",),
             "spot-check PNGs": ("matplotlib",),
             "volume figure": ("matplotlib",),
             "Moving-MNIST video": ("matplotlib", "cv2"),
             "sample panel": ("matplotlib",),
             "mask-tuning video": ("matplotlib", "cv2"),
             "legacy sequence video": ("matplotlib", "cv2"),
             "dashboard frame": ("cv2",),
             "dashboard video": ("matplotlib", "cv2")}
    drawing = {}
    for what, mods in needs.items():
        if all(avail[m] for m in mods):
            drawing[what] = ("drawn" if what not in drawn
                             or drawn[what] is not None else "MISSING")
        else:
            drawing[what] = ("said not drawn"
                             if f"{what} not drawn:" in said
                             and drawn.get(what) is None else "SILENT")
    want_div = np.gradient(u, 20.0)[2] + np.gradient(v, 20.0)[1] + \
        np.gradient(w, 20.0)[0]

    def rng_stats(a):
        return {"min": float(np.nanmin(a)), "max": float(np.nanmax(a)),
                "nan_frac": float(np.isnan(a).mean())}

    want_spot = {k: rng_stats(maps[k]) for k in ("u_map", "v_map", "w_map")}
    want_spot["render"] = rng_stats(render)
    panel = dashboard3d.jet_panel(maps["w_map"])
    gray = dashboard3d.gray_gamma_panel(render)
    r32 = np.asarray(render, np.float32)
    numbers = {
        "divergence": div == {
            "mean_abs_divergence": float(np.mean(np.abs(want_div))),
            "max_abs_divergence": float(np.max(np.abs(want_div))),
            "std_divergence": float(np.std(want_div))},
        "spot_check": spot == want_spot,
        "describe_pkl": viewers.describe_pkl(map_pkl).keys() == maps.keys(),
        "jet_panel": (panel.shape == maps["w_map"].shape + (3,)
                      and panel.dtype == np.uint8
                      and bool((panel[np.isnan(maps["w_map"])] == 0).all())),
        "gray_gamma_panel": bool(np.array_equal(gray[..., 0], (np.power(
            (r32 - r32.min()) / (r32.max() - r32.min()), 0.5)
            * 255).astype(np.uint8))),
        "legacy_windows": len(legacy_viewer.PKLSequenceDataset(legacy, 2,
                                                               1)) == 2}
    line = {"phase": "surface", "check": "viz", "available": avail,
            "numbers_equal_numpy": numbers, "drawing": drawing,
            "said": said.splitlines(),
            "ok": all(numbers.values()) and all(
                d in ("drawn", "said not drawn") for d in drawing.values())}
    emit(line)
    return line


def phase_surface(workdir: str, npz: str, chaindir: str):
    """Phase 15: the native gather, gen-mnist's paste, the DataLoader-based
    grain loader, convert-checkpoint with the int8 copy through evaluate,
    stats and inspect, doctor, and the viz modules. Returns the launch
    counts of the phase."""
    t0 = time.perf_counter()
    with open(FIT_CONFIG) as f:
        cfg = TrainConfig.from_dict(json.load(f))
    gate = os.path.join(chaindir, "gate")
    total = collections.Counter()
    _take(total)
    total.clear()
    lines = [surface_gather(npz, cfg)]   # timed on an otherwise idle host
    t_doctor = time.perf_counter()
    doctor = subprocess.Popen([sys.executable, "-m",
                               "unet_convlstm_tpu_torch", "doctor"],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        lines += [surface_gen_mnist(npz), surface_loader(npz, cfg),
                  surface_convert(workdir, npz, cfg, total),
                  surface_stats_inspect(workdir, npz, gate),
                  surface_viz(workdir, npz, gate),
                  surface_doctor(doctor, t_doctor)]
    finally:
        if doctor.poll() is None:
            doctor.kill()
            doctor.wait()
    _take(total)
    failed = [ln["check"] for ln in lines if not ln["ok"]]
    emit({"phase": "surface", "check": "summary", "failed": failed,
          "wall_s": time.perf_counter() - t0})
    if failed:
        raise AssertionError(f"surface checks failed: {failed}")
    return dict(total)


# ---------------------------------------------------------------------------
# 16. a reproducible training run on the card
# ---------------------------------------------------------------------------

REPRO_LAUNCHES = 20       # K2 launches a training shape, one set of inputs
# best val MAE of three runs of `cloud-gate --production` on an H100 before
# K2's sums were fixed-order and the training paths deterministic (PERF.md
# section 6, ROADMAP.md section C)
GATE_EARLIER_MAE = (0.2285, 0.2520, 0.1938)


def repro_k2(gen):
    """K2 REPRO_LAUNCHES times at each shape of the training step (bf16,
    B*T = 640) from the same inputs: y, sum and sumsq bit-identical."""
    lines = []
    for side, cin, cout, pro, _ in K2_TRAIN_CONVS:
        args = _k2_inputs(gen, TB * TT, side, cin, cout, pro, torch.bfloat16)
        ref = doubleconv_fused.fused_conv3x3(*args)
        same = [all(_bitequal_nan(a, b) for a, b in zip(
            ref, doubleconv_fused.fused_conv3x3(*args)))
            for _ in range(REPRO_LAUNCHES - 1)]
        torch.cuda.synchronize()
        route, plan = _k2_plan(TB * TT, side, cin, cout, torch.bfloat16)
        line = {"phase": "repro", "check": "conv3x3_fused",
                "shape": [TB * TT, side, side, cin, cout], "prologue": pro,
                "route": route, "plan": plan, "launches": REPRO_LAUNCHES,
                "bit_identical": all(same)}
        emit(line)
        lines.append(line)
    if not all(ln["bit_identical"] for ln in lines):
        raise AssertionError("K2's outputs differ from launch to launch")
    return lines


def _train_state(model, opt):
    return (copy.deepcopy(model.state_dict()),
            copy.deepcopy(opt.state_dict()["adamw"]["state"]))


def repro_steps(tr: _Train):
    """Three training steps of the benchmark's configuration (bf16, both
    kernels) twice from the seeded init: losses, parameters, BatchNorm
    statistics and AdamW's moments bit-identical."""
    runs = []
    with deterministic(DEV):
        for _ in range(2):
            opt = tr.fresh()
            step = tr.step(DEFAULT_POLICY, True)
            losses = [step(tr.model, opt, tr.x, tr.y)[0].item()
                      for _ in range(TRAIN_STEPS)]
            runs.append((losses, *_train_state(tr.model, opt)))
    (la, ma, oa), (lb, mb, ob) = runs
    line = {"phase": "repro", "check": "train_steps", "B": TB, "T": TT,
            "H": THW, "base_ch": TBASE, "dtype": "bfloat16",
            "steps": TRAIN_STEPS, "losses": [la, lb],
            "losses_equal": la == lb,
            "params_and_bn_equal": all(torch.equal(ma[k], mb[k])
                                       for k in ma),
            "moments_equal": all(torch.equal(oa[i][k], ob[i][k])
                                 for i in oa for k in oa[i])}
    line["ok"] = (line["losses_equal"] and line["params_and_bn_equal"]
                  and line["moments_equal"])
    emit(line)
    if not line["ok"]:
        raise AssertionError("two runs of the training steps differ")
    return line


def phase_repro(gen, gate: dict):
    """K2's sums, the training step and the production gate, each run
    twice; ``gate`` is phase 14's gate result."""
    repro_k2(gen)
    torch.cuda.empty_cache()
    repro_steps(_Train())
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        _, again = gate_production(workdir)
    maes = [r["val_mae"] for r in gate["history"] if "val_mae" in r]
    maes2 = [r["val_mae"] for r in again["history"] if "val_mae" in r]
    line = {"phase": "repro", "check": "cloud_gate",
            "best_val_mae": [gate["best_val_mae"], again["best_val_mae"]],
            "best_equal": gate["best_val_mae"] == again["best_val_mae"],
            "val_mae_per_epoch_equal": maes == maes2,
            "before_fix_best_val_mae": list(GATE_EARLIER_MAE),
            "before_fix_spread": (max(GATE_EARLIER_MAE)
                                  - min(GATE_EARLIER_MAE))}
    line["ok"] = line["best_equal"] and line["val_mae_per_epoch_equal"]
    emit(line)
    if not line["ok"]:
        raise AssertionError("two production gates gave other val MAEs")
    return line


# ---------------------------------------------------------------------------
# 17. data parallelism on the one card
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_EVAL_N, DP_EVAL_B, DP_ROLL_B = 16, 8, 4   # sequences; eval, rollout batch
# The two ranks against one process, each step from the same state on both
# sides (phase 5's measures). The ranks' per-channel sums and gradients are
# all-reduced, so they add in another order than one pass does. f32 (TF32
# off): TRAIN_F32_TOL. bf16 (the benchmark's configuration, K2's wgmma
# route): an activation rounded after those sums may land one bf16 ulp
# apart, and AdamW's update is about +-lr whatever |g| is, so an element
# whose gradient lies at that noise takes a noise-made sign. DP_BF16_TOL
# is about three times the largest of the three steps' readings of two
# ranks on an H100 (the loss 1.6e-5, the sums 7.7e-5, 3.7% of the elements
# beyond lr/2 and 0.065 lr RMS at the first step, BN 1.04e-4; the same
# bits every run). A control, each rank's BatchNorm statistics from its own
# rows (the mesh withheld from the model, the loss and gradients still
# summed), must fail at least one of them: it read BN 2.7e-3 to 5.1e-3 and
# the sums 1.1e-3 to 5.4e-3.
DP_BF16_TOL = dict(loss=1e-4, sums=3e-4, params_flipped=0.1,
                   params_rms_lr=0.2, bn=3e-4)
DP_TOL = dict(eval=1e-5, rollout=1e-5)
DP_TOL_WHY = ("two ranks against one process, each step from the same "
              "state, sums in another order: f32 (TF32 off) as phase 5's "
              f"train_f32; bf16 (the main path) the loss "
              f"{DP_BF16_TOL['loss']:g} and metric sums "
              f"{DP_BF16_TOL['sums']:g} relative, params at most "
              f"{DP_BF16_TOL['params_flipped']:.0%} of elements off by > "
              f"lr/2 and the rest {DP_BF16_TOL['params_rms_lr']:g} lr RMS, "
              f"BN stats {DP_BF16_TOL['bn']:g} of max(1, max|stat|), and "
              "per-rank BN statistics (the control) beyond at least one of "
              "these; ZeRO-1 against replicated and the NCCL group of one "
              "against no group bit-equal; evaluate_model and rollout_scan "
              "in f32 (TF32 off) 1e-5 relative, histograms equal")


def _gloo_cuda_probe(mesh):
    """Does gloo take CUDA tensors for each collective the port calls?
    (The data-parallel code passes them to it as they are.)"""
    out = {}
    for name, fn in (
            ("all_reduce", lambda t: dist.all_reduce(t, group=mesh.group)),
            ("all_gather", lambda t: dist.all_gather(
                [torch.empty_like(t) for _ in range(mesh.data)], t,
                group=mesh.group))):
        try:
            fn(torch.ones(8, device=DEV))
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:   # recorded; the phase then fails below
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _dp_steps(tr, mesh, x, y, zero1=False):
    """TRAIN_STEPS bf16 steps from the init, this process's rows, launches
    and wall times read around them."""
    with deterministic(DEV):
        opt = make_optimizer(_fresh_named(tr), LR, mesh=mesh, zero1=zero1)
        step = make_train_step(tr.flags(DEFAULT_POLICY, True), tr.norm,
                               mesh=mesh)
        torch.cuda.synchronize()
        reset_launches()
        losses, ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step(tr.model, opt, x, y)[0].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = path_counts()
        state = _train_state(tr.model, opt)
    return {"losses": losses, "ms": ms, "counts": counts,
            "state": to_host(state[0]), "moments": to_host(state[1])}


def _fresh_named(tr):
    tr.model.load_state_dict(tr.init)
    return tr.model.named_parameters()


def _dp_eval(tr, mesh, npz):
    """evaluate_model and rollout_scan in f32 (TF32 off) with this mesh."""
    tr.model.load_state_dict(tr.init)
    tr.model.eval()
    apply = tr.flags(FP32_POLICY, True)
    ds = NPZSequenceDataset(npz)
    _, _, _, init_state = build_model(benchmark.MODEL_CFG)
    with full_fp32():
        rep = evaluate_model(apply, tr.model, ds, indices=np.arange(len(ds)),
                             batch_size=DP_EVAL_B, use_mask=False, mesh=mesh)
        x = normalize_x(tr.x[:DP_ROLL_B], tr.norm)
        y, st = rollout_scan(apply, tr.model, x, init_state, mesh=mesh)
    tr.model.train()
    return {"report": rep.to_dict(), "y": to_host(y), "state": to_host(st)}


def _without_mesh(apply, model, x, train, mesh=None):
    """``apply`` with the mesh withheld: BatchNorm's statistics from this
    rank's rows alone (the control of phase 17)."""
    return apply(model, x, train=train)


def _dp_against_one_each_step(tr, mesh, policy, per_rank_bn=False):
    """TRAIN_STEPS steps on the ranks under ``policy`` (FP32_POLICY with
    TF32 off); before each, rank 0 also takes the one-process step on the
    whole batch from the same state and compares (phase 5's measures).
    ``per_rank_bn``: the control. Returns rank 0's comparisons."""
    rows = mesh.rows(TB)
    apply = tr.flags(policy, True)
    out = []
    with deterministic(DEV), (full_fp32() if policy is FP32_POLICY
                              else contextlib.nullcontext()):
        opt = make_optimizer(_fresh_named(tr), LR, mesh=mesh)
        dp = make_train_step(functools.partial(_without_mesh, apply)
                             if per_rank_bn else apply, tr.norm, mesh=mesh)
        one = make_train_step(apply, tr.norm)
        for _ in range(TRAIN_STEPS):
            before = _snapshot(tr.model, opt)
            ld, sd = dp(tr.model, opt, tr.x[rows].contiguous(),
                        tr.y[rows].contiguous())
            after = _snapshot(tr.model, opt)
            if mesh.rank == 0:
                _restore(tr.model, opt, before)
                lo, so = one(tr.model, opt, tr.x, tr.y)
                ref = _snapshot(tr.model, opt)
                flipped, rms = _params_diff(after[0], ref[0], tr.model)
                out.append({"loss": [ld.item(), lo.item()],
                            "loss_rel": abs(ld.item() / lo.item() - 1),
                            "sums_err": _sums_err(sd, so),
                            "params_flipped": flipped, "params_rms_lr": rms,
                            "bn_err": _bn_err(after[0], ref[0])})
                _restore(tr.model, opt, after)
    return out


def _within(steps, tol, n=TRAIN_STEPS) -> bool:
    """Every step's readings within ``tol`` (and ``n`` steps, as many as
    run)."""
    return len(steps) == n and all(
        st["loss_rel"] <= tol["loss"] and st["sums_err"] <= tol["sums"]
        and st["params_flipped"] <= tol["params_flipped"]
        and st["params_rms_lr"] <= tol["params_rms_lr"]
        and st["bn_err"] <= tol["bn"] for st in steps)


def _dp_rank(mesh, npz):
    """One gloo rank on the card: replicated and ZeRO-1 bf16 steps on its
    rows of the benchmark's batch, the f32 and bf16 steps against one
    process and the bf16 control, evaluation and rollout, gloo's own CUDA
    support."""
    torch.cuda.set_device(0)
    tr = _Train()
    rows = mesh.rows(TB)
    x, y = tr.x[rows].contiguous(), tr.y[rows].contiguous()
    return {"gloo_cuda": _gloo_cuda_probe(mesh),
            "replicated": _dp_steps(tr, mesh, x, y),
            "zero1": _dp_steps(tr, mesh, x, y, zero1=True),
            "f32": _dp_against_one_each_step(tr, mesh, FP32_POLICY),
            "bf16": _dp_against_one_each_step(tr, mesh, DEFAULT_POLICY),
            "bf16_per_rank_bn": _dp_against_one_each_step(
                tr, mesh, DEFAULT_POLICY, per_rank_bn=True),
            "eval": _dp_eval(tr, mesh, npz)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _dp_against_one(ranks, one, model):
    """The ranks' free-running bf16 steps against one process's (reported,
    not held: they part within a step or two, each step's difference
    carried into the next): the losses, and the parameters after the three
    steps in units of lr; and whether the ranks hold the same bits."""
    got = ranks[0]["replicated"]
    names = [n for n, _ in model.named_parameters()]
    d = np.concatenate([((got["state"][n] - one["state"][n]) / LR).ravel()
                        for n in names])
    big = np.abs(d) > 0.5
    loss_rel = [abs(a / b - 1) for a, b in zip(got["losses"],
                                               one["losses"])]
    return {"losses": got["losses"], "one_process_losses": one["losses"],
            "loss_rel": loss_rel,
            "bf16_params_flipped_after_3": float(big.mean()),
            "bf16_params_rms_lr_after_3": float(np.sqrt((d[~big] ** 2)
                                                        .mean())),
            "ranks_agree": all(
                r["replicated"]["losses"] == got["losses"]
                and all(np.array_equal(r["replicated"]["state"][k], v)
                        for k, v in got["state"].items())
                for r in ranks)}


def _states_equal(a, b) -> bool:
    return (all(np.array_equal(a["state"][k], v)
                for k, v in b["state"].items())
            and all(np.array_equal(x, y) for x, y in zip(
                _leaves(a["moments"]), _leaves(b["moments"])))
            and a["losses"] == b["losses"])


def phase_dp(workdir: str):
    """Two gloo ranks on the card against one process; ZeRO-1; eval and
    rollout; an NCCL group of one. Returns the ranks' launch counts per
    step."""
    npz = os.path.join(workdir, "dp.npz")
    moving_mnist.save_moving_mnist_npz(npz, seq_len=TT,
                                       num_samples=DP_EVAL_N,
                                       image_size=THW, seed=SEED + 11,
                                       as_xy=True)
    t0 = time.perf_counter()
    ranks = run_local_ranks(_dp_rank, DP_RANKS, (npz,), backend="gloo",
                            timeout_s=600, group_timeout_s=300)
    ranks_wall = time.perf_counter() - t0
    tr = _Train()
    one = _dp_steps(tr, None, tr.x, tr.y)
    one_eval = _dp_eval(tr, None, npz)
    # the same data-parallel step on an NCCL group of one rank: every
    # collective runs, bit-equal to no group
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh1 = make_mesh(group=dist.group.WORLD)
        nccl = _dp_steps(tr, mesh1, tr.x, tr.y)
        nccl_z = _dp_steps(tr, mesh1, tr.x, tr.y, zero1=True)
        nccl_backend = mesh1.backend
    finally:
        dist.destroy_process_group()
    per_step = {k: v // TRAIN_STEPS for k, v in ranks[0]["replicated"]
                ["counts"].items()}
    expect = on_main_routes({"gate_update": K1_PER_STEP,
                             "gate_update_bwd": K1_PER_STEP,
                             "conv3x3_fused": K2_PER_STEP, **NO_LAUNCHES})
    counts_ok = all(r[m]["counts"] == {k: v * TRAIN_STEPS
                                       for k, v in expect.items()}
                    for r in ranks for m in ("replicated", "zero1"))
    cmp = _dp_against_one(ranks, one, tr.model)
    tol = DP_TOL
    f32, bf16 = ranks[0]["f32"], ranks[0]["bf16"]
    control = ranks[0]["bf16_per_rank_bn"]
    control_fails = (len(control) == TRAIN_STEPS
                     and not _within(control, DP_BF16_TOL))
    steps_ok = (cmp["ranks_agree"] and _within(f32, TRAIN_F32_TOL)
                and _within(bf16, DP_BF16_TOL) and control_fails)
    zero1_ok = all(_states_equal(r["zero1"], r["replicated"]) for r in ranks)
    nccl_ok = (_states_equal(nccl, one) and _states_equal(nccl_z, one)
               and nccl["counts"] == one["counts"])
    ev, ev1 = ranks[0]["eval"], one_eval
    m, s1 = ev["report"], ev1["report"]
    eval_err = max(_np_rel(m[k], s1[k]) for k in ("mae", "rmse",
                                                  "mae_over_time"))
    eval_ok = (eval_err <= tol["eval"] and m["n_pixels"] == s1["n_pixels"]
               and all(np.array_equal(m[k], s1[k])
                       for k in ("gt_hist", "pred_hist", "err_hist")))
    roll_err = max([_np_rel(ev["y"], ev1["y"])] + [
        _np_rel(a, b) for a, b in zip(_leaves(ev["state"]),
                                      _leaves(ev1["state"]))])
    roll_ok = roll_err <= tol["rollout"]
    line = {"phase": "dp", "ranks": DP_RANKS, "backend": "gloo",
            "device": "cuda:0 shared", "B": TB,
            "rows_per_rank": TB // DP_RANKS,
            "T": TT, "H": THW, "base_ch": TBASE, "dtype": "bfloat16",
            "steps": TRAIN_STEPS, "gloo_cuda": ranks[0]["gloo_cuda"],
            "launches_per_rank_per_step": per_step, "expected": expect,
            "counts_ok": counts_ok, **cmp, "f32_steps": f32,
            "bf16_steps": bf16, "bf16_tol": DP_BF16_TOL,
            "control_per_rank_bn_steps": control,
            "control_fails_bf16_tol": control_fails, "steps_ok": steps_ok,
            "zero1_bit_equal_replicated": zero1_ok,
            "nccl_world_1": {"backend": nccl_backend,
                             "bit_equal_no_group": nccl_ok,
                             "launches": nccl["counts"]},
            "nccl_multi_rank": "unverified: one card, and NCCL takes one "
                               "rank a device",
            "eval_rel_err": eval_err, "eval_ok": eval_ok,
            "rollout_rel_err": roll_err, "rollout_ok": roll_ok,
            "shared_card_step_ms": {
                "rank0": ranks[0]["replicated"]["ms"],
                "rank1": ranks[1]["replicated"]["ms"],
                "one_process": one["ms"],
                "note": "two processes sharing one card: no data-parallel "
                        "speed"},
            "ranks_wall_s": ranks_wall, "tol": DP_TOL_WHY}
    line["ok"] = (counts_ok and steps_ok and zero1_ok and nccl_ok and eval_ok
                  and roll_ok and all(v == "ok" for v in
                                      ranks[0]["gloo_cuda"].values()))
    emit(line)
    if not line["ok"]:
        raise AssertionError("data parallelism on the card failed")
    return per_step


# ---------------------------------------------------------------------------
# 18. tensor parallelism on the one card
# ---------------------------------------------------------------------------

# (data, model, steps): 2 and 4 gloo ranks. Each tensor-parallel step of
# the benchmark's batch moves its gathered activations and summed input
# gradients through gloo's host copies (3 to 9 s a step on an H100's
# machine; PERF.md), so the four-rank mesh takes two steps a run, not three
TP_MESHES = ((1, 2, 3), (2, 2, 2))
TP_MODEL = 2
# The ranks against one process, each step from the same state on both
# sides (phase 5's measures). A tensor-parallel step computes the same
# function: each rank's convs compute its block of output channels with
# the same per-channel sums, but a conv's input gradient is the sum of the
# blocks' partial gradients (added over the model group in f32 and rounded
# once to the activation's dtype), the global norm adds the shards'
# squared norms over the group, and with D = 2 the data-parallel sums of
# phase 17 add in another order too. f32 (TF32 off): TRAIN_F32_TOL. bf16
# (the benchmark's configuration): an input gradient rounded to bf16 after
# another order of sums may land one ulp apart, and AdamW's update is about
# +-lr whatever |g| is, so an element whose gradient lies at that noise
# takes a noise-made sign. TP_BF16_TOL is about three times the largest of
# the steps' readings of both meshes on an H100 (the loss 2.4e-5, the sums
# 3.0e-4, 3.8% of the elements beyond lr/2 and 0.066 lr RMS at the first
# step, BN 1.18e-4; PERF.md section 6).
TP_BF16_TOL = dict(loss=1e-4, sums=1e-3, params_flipped=0.12,
                   params_rms_lr=0.2, bn=3.5e-4)
TP_TOL_WHY = ("the ranks of each mesh against one process, each step from "
              "the same state: f32 (TF32 off) as phase 5's train_f32; bf16 "
              f"the loss {TP_BF16_TOL['loss']:g} and metric sums "
              f"{TP_BF16_TOL['sums']:g} relative, params at most "
              f"{TP_BF16_TOL['params_flipped']:.0%} of elements off by > "
              f"lr/2 and the rest {TP_BF16_TOL['params_rms_lr']:g} lr RMS, "
              f"BN stats {TP_BF16_TOL['bn']:g} of max(1, max|stat|); the "
              "replicated leaves and the gathered shards the same bits on "
              "every rank; ZeRO-1 on top bit-equal to replicated moments; "
              "K2 at each Cout/2 shape as conv3x3_fused; evaluate_model "
              "and rollout_scan in f32 (TF32 off) 1e-5 relative, "
              "histograms equal")


def k2_tp_convs(base, hw, model):
    """``k2_convs`` of a rank whose convs hold 1/model of the output
    channels (conv2 reads all of conv1's)."""
    return [(side, cin, cout // model, pro, n)
            for side, cin, cout, pro, n in k2_convs(base, hw)]


def _gloo_cuda_groups(mesh):
    """Does gloo take CUDA tensors for each collective the tensor-parallel
    code calls, on the whole group and the grid's data and model groups?
    (all-reduce of f32, all-gather of f32 and bf16)"""
    out = {}
    for axis, group, size in (("world", mesh.group, mesh.data * mesh.model),
                              ("data", mesh.data_group, mesh.data),
                              ("model", mesh.model_group, mesh.model)):
        for name, dtype, fn in (
                ("all_reduce_f32", torch.float32,
                 lambda t, g=group: dist.all_reduce(t, group=g)),
                ("all_gather_f32", torch.float32,
                 lambda t, g=group, n=size: dist.all_gather(
                     [torch.empty_like(t) for _ in range(n)], t, group=g)),
                ("all_gather_bf16", torch.bfloat16,
                 lambda t, g=group, n=size: dist.all_gather(
                     [torch.empty_like(t) for _ in range(n)], t, group=g))):
            try:
                fn(torch.ones(8, device=DEV, dtype=dtype))
                torch.cuda.synchronize()
                out[f"{axis}.{name}"] = "ok"
            except Exception as e:   # recorded; the phase then fails below
                out[f"{axis}.{name}"] = (f"{type(e).__name__}: "
                                         f"{str(e).splitlines()[0][:160]}")
    return out


def _digests(named) -> dict:
    """Each tensor's bytes as a SHA-1 (bit-identity without moving the
    tensors between processes)."""
    return {k: hashlib.sha1(v.detach().reshape(-1).contiguous()
                            .view(torch.uint8).cpu().numpy().tobytes())
            .hexdigest() for k, v in named.items()}


def _moment_digests(opt) -> dict:
    return _digests({f"{i}.{k}": t for i, st in
                     opt.state_dict()["adamw"]["state"].items()
                     for k, t in st.items()})


def _tp_model(mesh, zero1=False):
    """The benchmark's model from the seeded init, narrowed to this rank's
    shards by the JAX rule."""
    _, init, _, _ = build_model(benchmark.MODEL_CFG)
    model = init(torch.Generator().manual_seed(SEED), device=DEV)
    sharding = MeshRules(mesh, shard_model_channels=True,
                         shard_opt_state_data=zero1
                         ).tree_sharding(model.state_dict())
    return shard_model(model, sharding), sharding


def _tp_steps(tr, mesh, policy, steps, zero1=False, compare=True):
    """``steps`` steps of the tensor-parallel step from the init under
    ``policy`` (FP32_POLICY with TF32 off), this rank's rows, launches and
    wall times read around each step. ``compare``: before each step rank 0
    also takes the one-process step on the whole batch from the same state
    (the ranks' state gathered) and compares (phase 5's measures)."""
    rows = mesh.rows(TB)
    x, y = tr.x[rows].contiguous(), tr.y[rows].contiguous()
    apply = tr.flags(policy, True)
    counts = collections.Counter()
    losses, ms, cmp = [], [], []
    with deterministic(DEV), (full_fp32() if policy is FP32_POLICY
                              else contextlib.nullcontext()):
        model, sharding = _tp_model(mesh, zero1)
        opt = make_optimizer(model.named_parameters(), LR, mesh=mesh,
                             zero1=zero1)
        step = make_train_step(apply, tr.norm, mesh=mesh,
                               state_sharding=sharding)
        one = make_train_step(apply, tr.norm)
        one_opt = make_optimizer(_fresh_named(tr), LR)
        for _ in range(steps):
            if compare:      # a collective: every rank gathers
                before = copy.deepcopy((full_state_dict(model, mesh),
                                        opt.state_dict()))
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            loss, sums = step(model, opt, x, y)
            losses.append(loss.item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts.update(path_counts())
            if not compare:
                continue
            after = full_state_dict(model, mesh)
            if mesh.rank == 0:
                tr.model.load_state_dict(before[0])
                one_opt.load_state_dict(before[1])
                lo, so = one(tr.model, one_opt, tr.x, tr.y)
                ref = tr.model.state_dict()
                flipped, rms = _params_diff(after, ref, tr.model)
                cmp.append({"loss": [losses[-1], lo.item()],
                            "loss_rel": abs(losses[-1] / lo.item() - 1),
                            "sums_err": _sums_err(sums, so),
                            "params_flipped": flipped, "params_rms_lr": rms,
                            "bn_err": _bn_err(after, ref)})
            del after
        replicated = {n: t for n, t in model.state_dict().items()
                      if sharding.model_axis(n) is None}
        return {"losses": losses, "ms": ms, "counts": dict(counts),
                "steps": cmp, "replicated": _digests(replicated),
                "gathered": _digests(full_state_dict(model, mesh)),
                "moments": _moment_digests(opt)}


def _tp_eval(tr, mesh, npz):
    """evaluate_model (variables_sharding) and rollout_scan in f32 (TF32
    off) with the sharded model at the init."""
    model, sharding = _tp_model(mesh)
    model.eval()
    apply = tr.flags(FP32_POLICY, True)
    ds = NPZSequenceDataset(npz)
    _, _, _, init_state = build_model(benchmark.MODEL_CFG)
    with full_fp32():
        rep = evaluate_model(apply, model, ds, indices=np.arange(len(ds)),
                             batch_size=DP_EVAL_B, use_mask=False, mesh=mesh,
                             variables_sharding=sharding)
        x = normalize_x(tr.x[:DP_ROLL_B], tr.norm)
        y, st = rollout_scan(apply, model, x, init_state, mesh=mesh)
    return {"report": rep.to_dict(), "y": to_host(y), "state": to_host(st)}


def _tp_rank(mesh, npz, steps):
    """One gloo rank of a tensor-parallel mesh on the card: gloo's CUDA
    support on the grid's groups, the bf16 and f32 steps against one
    process, ZeRO-1 on top (D > 1), evaluation and rollout."""
    torch.cuda.set_device(0)
    tr = _Train()
    out = {"gloo_cuda": _gloo_cuda_groups(mesh),
           "bf16": _tp_steps(tr, mesh, DEFAULT_POLICY, steps)}
    if mesh.data > 1:
        out["zero1"] = _tp_steps(tr, mesh, DEFAULT_POLICY, steps,
                                 zero1=True, compare=False)
    out["f32"] = _tp_steps(tr, mesh, FP32_POLICY, steps)
    out["eval"] = _tp_eval(tr, mesh, npz)
    return out


def _tp_mesh_line(data, steps, ranks, one_eval, wall):
    """The checks of one mesh's ranks, as its line."""
    r0 = ranks[0]
    expect = on_main_routes({"gate_update": K1_PER_STEP,
                             "gate_update_bwd": K1_PER_STEP,
                             "conv3x3_fused": K2_PER_STEP, **NO_LAUNCHES})
    runs = [m for m in ("bf16", "zero1", "f32") if m in r0]
    # the bf16 runs on the main path's routes; the f32 run's K2 calls take
    # the generic route, as under the FP32 policy in one process
    f32_expect = dict(expect, conv3x3_fused_wgmma=0,
                      conv3x3_fused_generic=K2_PER_STEP)
    counts_ok = all(r[m]["counts"] == {
        k: v * steps for k, v in (f32_expect if m == "f32"
                                  else expect).items()}
        for r in ranks for m in runs)
    per_step = {k: v // steps for k, v in r0["bf16"]["counts"].items()}
    same = {m: {k: all(r[m][k] == r0[m][k] for r in ranks)
                for k in ("replicated", "gathered", "moments")}
            for m in runs}
    bit_identical = all(all(v.values()) for v in same.values()) and all(
        r[m]["losses"] == r0[m]["losses"] for r in ranks for m in runs)
    zero1_ok = None
    if "zero1" in r0:
        zero1_ok = all(r["zero1"][k] == r["bf16"][k]
                       for r in ranks for k in ("losses", "gathered",
                                                "moments"))
    f32, bf16 = r0["f32"]["steps"], r0["bf16"]["steps"]
    steps_ok = (_within(f32, TRAIN_F32_TOL, steps)
                and _within(bf16, TP_BF16_TOL, steps))
    ev, ev1 = r0["eval"], one_eval
    m, s1 = ev["report"], ev1["report"]
    eval_err = max(_np_rel(m[k], s1[k]) for k in ("mae", "rmse",
                                                  "mae_over_time"))
    eval_ok = (eval_err <= DP_TOL["eval"] and m["n_pixels"] == s1["n_pixels"]
               and all(np.array_equal(m[k], s1[k])
                       for k in ("gt_hist", "pred_hist", "err_hist")))
    roll_err = max([_np_rel(ev["y"], ev1["y"])] + [
        _np_rel(a, b) for a, b in zip(_leaves(ev["state"]),
                                      _leaves(ev1["state"]))])
    gloo_ok = all(v == "ok" for r in ranks for v in r["gloo_cuda"].values())
    line = {"phase": "tp", "mesh": {"data": data, "model": TP_MODEL},
            "ranks": len(ranks), "backend": "gloo",
            "device": "cuda:0 shared", "B": TB, "rows_per_rank": TB // data,
            "T": TT, "H": THW, "base_ch": TBASE, "steps": steps,
            "runs": runs, "gloo_cuda": r0["gloo_cuda"], "gloo_ok": gloo_ok,
            "launches_per_rank_per_step": per_step, "expected": expect,
            "counts_ok": counts_ok, "bf16_losses": r0["bf16"]["losses"],
            "f32_steps": f32, "bf16_steps": bf16, "bf16_tol": TP_BF16_TOL,
            "steps_ok": steps_ok, "ranks_same_bits": same,
            "bit_identical": bit_identical,
            "zero1_bit_equal_replicated": zero1_ok,
            "eval_rel_err": eval_err, "eval_ok": eval_ok,
            "rollout_rel_err": roll_err,
            "rollout_ok": roll_err <= DP_TOL["rollout"],
            "shared_card_step_ms": {
                **{f"rank{i}_{m}": r[m]["ms"] for i, r in enumerate(ranks)
                   for m in runs},
                "note": "processes sharing one card: no tensor-parallel "
                        "speed"},
            "nccl_multi_rank": "unverified: one card, and NCCL takes one "
                               "rank a device",
            "ranks_wall_s": wall}
    line["ok"] = (gloo_ok and counts_ok and steps_ok and bit_identical
                  and zero1_ok is not False and eval_ok
                  and line["rollout_ok"])
    return line, per_step


def phase_tp(workdir: str, gen):
    """Tensor parallelism on the card: K2 at each rank's Cout/2 shapes, then
    gloo ranks sharing cuda:0 at each mesh of TP_MESHES against one
    process. Returns the ranks' launch counts per step and K2's totals."""
    t_phase = time.perf_counter()
    k2 = {}
    for data, _, _ in TP_MESHES:
        k2[data] = check_k2(gen, k2_tp_convs(TBASE, THW, TP_MODEL),
                            (TB // data) * TT, f"tp_rank_step_d{data}",
                            serving=False)
    npz = os.path.join(workdir, "tp.npz")
    moving_mnist.save_moving_mnist_npz(npz, seq_len=TT,
                                       num_samples=DP_EVAL_N,
                                       image_size=THW, seed=SEED + 11,
                                       as_xy=True)
    one_eval = _dp_eval(_Train(), None, npz)
    lines, per_step = [], None
    for data, model, steps in TP_MESHES:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_local_ranks(_tp_rank, data * model, (npz, steps),
                                backend="gloo", timeout_s=900,
                                group_timeout_s=300, model=model)
        line, per_step = _tp_mesh_line(data, steps, ranks, one_eval,
                                       time.perf_counter() - t0)
        emit(line)
        lines.append(line)
    summary = {"phase": "tp_summary",
               "meshes": [ln["mesh"] for ln in lines],
               "ok": [ln["ok"] for ln in lines],
               "k2_cout_half_ms_per_rank_step": {
                   f"rows_{TB // d}": {k: t[k] for k in (
                       "ms", "plain_ms", "library_ms", "bound_ms")}
                   for d, t in k2.items()},
               "phase_wall_s": time.perf_counter() - t_phase,
               "note": "processes sharing one card: no tensor-parallel "
                       "speed; multi-rank NCCL unverified (one card)"}
    emit(summary)
    if not all(summary["ok"]):
        raise AssertionError("tensor parallelism on the card failed")
    return per_step, k2


# ---------------------------------------------------------------------------
# 19. the rest of the mesh surface on the one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MULTI_K, MULTI_K_RANKS = 4, 2        # steps a call: one process; the ranks
SP_MICROBATCHES = (1, 2, 4)
SP_TS = (TT, TT - 1)                 # T = 9: padded to two chunks of 5
SP_F32_TOL = 1e-5                    # rtol and atol, as the CPU tests
SP_BF16_RATIO = 1.25
# "time" against "batch": one bf16 step from the same state computes the
# same function with BatchNorm's sums over the frames in another order,
# the difference phase 17 bounds between two ranks and one process
LAYOUT_TOL = DP_BF16_TOL
MESH_TOL_WHY = (
    "multi-step: K steps a call bit-equal to K calls of the single step "
    "(losses, metric sums, parameters, BN statistics, AdamW moments), in "
    "one process and on two gloo ranks; remat: the step's loss, gradients, "
    "parameters and BN statistics bit-equal to the step without it (the "
    "recomputed forward runs the same deterministic kernels); flat_layout "
    "'batch' against 'time': phase 17's bf16 bounds (BN sums over the "
    "frames in another order); pipelined ConvLSTM on two ranks against "
    f"convlstm in one process: f32 (TF32 off) |a - b| <= {SP_F32_TOL:g} + "
    f"{SP_F32_TOL:g} |b| (the one-process bottleneck hoists the input "
    "projection: the same sums split in two), bf16 each output's RMS "
    f"error against the f32 one-process output at most {SP_BF16_RATIO}x "
    "the bf16 one-process output's (they round at other places), the "
    "ranks the same bits; stages B and C on two ranks, and the CLI's "
    "--data-parallel (one process on the card; torchrun with two CPU "
    "ranks), byte-equal to one process's pkls")


def _multi_vs_single(tr, mesh, k):
    """``make_multi_train_step``'s k bf16 steps in one call against k calls
    of ``make_train_step``, each from the seeded init on this process's
    rows of the benchmark batch: bit-equality, the multi call's launches
    and both wall times."""
    rows = mesh.rows(TB) if mesh is not None else slice(None)
    x, y = tr.x[rows].contiguous(), tr.y[rows].contiguous()
    apply = tr.flags(DEFAULT_POLICY, True)
    runs = {}
    with deterministic(DEV):
        for kind in ("multi", "single"):
            opt = tr.fresh(mesh=mesh)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            if kind == "multi":
                losses, sums = make_multi_train_step(
                    apply, tr.norm, mesh=mesh)(tr.model, opt,
                                               torch.stack([x] * k),
                                               torch.stack([y] * k))
                sums = torch.stack(list(sums))
            else:
                step = make_train_step(apply, tr.norm, mesh=mesh)
                each = [step(tr.model, opt, x, y) for _ in range(k)]
                losses = torch.stack([loss for loss, _ in each])
                sums = torch.stack([torch.stack(list(s))
                                    for _, s in each]).sum(dim=0)
            torch.cuda.synchronize()
            runs[kind] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                          "counts": path_counts(),
                          "losses": losses.tolist(),
                          "bits": {**_digests({"losses": losses,
                                               "sums": sums}),
                                   **_digests(tr.model.state_dict()),
                                   **_moment_digests(opt)}}
    m, s1 = runs["multi"], runs["single"]
    return {"k": k, "bit_equal": m["bits"] == s1["bits"],
            "counts": m["counts"], "single_counts": s1["counts"],
            "losses": m["losses"], "multi_wall_ms": m["wall_ms"],
            "single_wall_ms": s1["wall_ms"], "bits": m["bits"]}


def _probe_step(tr, **apply_kw):
    """One bf16 step of the benchmark from the seeded init with
    ``apply_kw`` bound into the model's apply: its loss, gradients, state
    after the step, launches and peak memory."""
    with deterministic(DEV):
        opt = tr.fresh()
        step = make_train_step(functools.partial(
            tr.flags(DEFAULT_POLICY, True), **apply_kw), tr.norm)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        loss, sums = step(tr.model, opt, tr.x, tr.y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        # on the host, so that the next probe's peak holds none of it
        return {"loss": loss.detach().cpu(),
                "sums": MetricSums(*(t.cpu() for t in sums)),
                "grads": {n: p.grad.detach().cpu()
                          for n, p in tr.model.named_parameters()
                          if p.grad is not None},
                "state": {k: v.detach().cpu()
                          for k, v in tr.model.state_dict().items()},
                "counts": path_counts(), "wall_ms": wall,
                "peak_gib": peak / 2 ** 30,
                "peak_over_start_gib": (peak - before) / 2 ** 30}


def mesh_remat_layout(tr):
    """One bf16 step with and without remat (bit-equal; peak memory and
    launches both ways), and in each flat layout (within LAYOUT_TOL)."""
    plain = _probe_step(tr)
    remat = _probe_step(tr, remat=True)
    batch = _probe_step(tr, flat_layout="batch")
    expect = on_main_routes({"gate_update": K1_PER_STEP,
                             "gate_update_bwd": K1_PER_STEP,
                             "conv3x3_fused": K2_PER_STEP, **NO_LAUNCHES})
    # the recomputed encoder and decoder run every fused conv once more
    remat_expect = on_main_routes(dict(expect,
                                       conv3x3_fused=2 * K2_PER_STEP))
    remat_equal = {
        "loss": torch.equal(plain["loss"], remat["loss"]),
        "grads": plain["grads"].keys() == remat["grads"].keys() and all(
            torch.equal(g, remat["grads"][n])
            for n, g in plain["grads"].items()),
        "params_and_bn": all(torch.equal(v, remat["state"][k])
                             for k, v in plain["state"].items())}
    flipped, rms = _params_diff(batch["state"], plain["state"], tr.model)
    layout = {"loss": [batch["loss"].item(), plain["loss"].item()],
              "loss_rel": abs(batch["loss"].item() / plain["loss"].item()
                              - 1),
              "sums_err": _sums_err(batch["sums"], plain["sums"]),
              "params_flipped": flipped, "params_rms_lr": rms,
              "bn_err": _bn_err(batch["state"], plain["state"])}
    line = {"phase": "mesh", "check": "remat_and_flat_layout", "B": TB,
            "T": TT, "H": THW, "base_ch": TBASE, "dtype": "bfloat16",
            "remat_bit_equal": remat_equal,
            "peak_gib": {"plain": plain["peak_gib"],
                         "remat": remat["peak_gib"],
                         "batch_layout": batch["peak_gib"]},
            "peak_over_start_gib": {"plain": plain["peak_over_start_gib"],
                                    "remat": remat["peak_over_start_gib"]},
            "step_ms": {"plain": plain["wall_ms"], "remat": remat["wall_ms"],
                        "batch_layout": batch["wall_ms"]},
            "launches": {"plain": plain["counts"], "remat": remat["counts"],
                         "batch_layout": batch["counts"]},
            "expected": {"plain": expect, "remat": remat_expect},
            "batch_vs_time": layout, "layout_tol": LAYOUT_TOL}
    line["counts_ok"] = (plain["counts"] == expect
                         and batch["counts"] == expect
                         and remat["counts"] == remat_expect)
    line["ok"] = (all(remat_equal.values()) and line["counts_ok"]
                  and _within([layout], LAYOUT_TOL, n=1))
    emit(line)
    return line


def _sp_inputs():
    """The benchmark model's bottleneck ConvLSTM (``temporal``: 512 -> 512
    at 4x4) from the seeded init, and a seeded input [T, B, 4, 4, 512]."""
    _, init, _, _ = build_model(benchmark.MODEL_CFG)
    lstm = init(torch.Generator().manual_seed(SEED), device=DEV).temporal
    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    side, c = THW // 16, 16 * TBASE
    return lstm, torch.randn((TT, TB, side, side, c), generator=g,
                             device=DEV)


def _sp_expected_k1(mesh, T, M):
    """K1 launches of one pipelined call on this rank: one a real frame
    of its chunk a microbatch."""
    chunk = -(-T // mesh.data)
    return M * max(0, min(chunk, T - mesh.data_rank * chunk))


def _sp_rank(mesh):
    """The pipelined bottleneck layer at every (policy, T, M) on this rank:
    K1 launches against the expectation, digests of the outputs, and on
    rank 0 the errors against ``convlstm`` in one process."""
    lstm, x = _sp_inputs()
    out = {}
    refs = {}
    for tag, policy in (("f32", FP32_POLICY), ("bf16", DEFAULT_POLICY)):
        for T in SP_TS:
            with (full_fp32() if tag == "f32" else contextlib.nullcontext()):
                if mesh.rank == 0 and (tag, T) not in refs:
                    with torch.no_grad():
                        y, [(h, c)] = convlstm(lstm, x[:T], policy=policy,
                                               use_pallas=True)
                    refs[tag, T] = (y, h, c)
                for M in SP_MICROBATCHES:
                    torch.cuda.synchronize()
                    reset_launches()
                    t0 = time.perf_counter()
                    y, (h, c) = convlstm_time_pipelined(
                        lstm.layers[0], x[:T], mesh, microbatches=M,
                        policy=policy)
                    torch.cuda.synchronize()
                    case = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                            "k1": convlstm_fused.launches,
                            "k1_vector": convlstm_fused.launches_by_route[
                                "vector"],
                            "k1_expected": _sp_expected_k1(mesh, T, M),
                            "shapes": [list(t.shape) for t in (y, h, c)],
                            "digests": _digests({"y": y, "h": h, "c": c})}
                    if mesh.rank == 0:
                        case["got"] = (y, h, c)
                    out[tag, T, M] = case
    if mesh.rank != 0:
        return out
    for (tag, T, M), case in out.items():
        got, ref = case.pop("got"), refs[tag, T]
        if tag == "f32":
            case["max_excess"] = max(
                float(((a.float() - b.float()).abs()
                       - SP_F32_TOL * (1 + b.float().abs())).max())
                for a, b in zip(got, ref))
            case["rel_err"] = [rel_err(a, b) for a, b in zip(got, ref)]
        else:
            f32 = refs["f32", T]
            case["rms_vs_f32"] = [rms_rel_err(a, b) for a, b in zip(got, f32)]
            case["one_process_rms_vs_f32"] = [
                rms_rel_err(a, b) for a, b in zip(ref, f32)]
            case["rms_vs_one_process"] = [rms_rel_err(a, b)
                                          for a, b in zip(got, ref)]
    return out


def _mesh_rank(mesh, workdir, roots):
    """One gloo rank on the card: the multi-step at K = MULTI_K_RANKS
    against as many data-parallel steps, the pipelined ConvLSTM, and
    stages B and C over the ranks into ``workdir``."""
    torch.cuda.set_device(0)
    tr = _Train()
    multi = _multi_vs_single(tr, mesh, MULTI_K_RANKS)
    del tr
    torch.cuda.empty_cache()
    sp = _sp_rank(mesh)
    torch.cuda.empty_cache()
    (b_root, b_csv), (c_root, c_csv) = roots
    t0 = time.perf_counter()
    stage_b = {tag: render_dataset(
        b_root, os.path.join(workdir, f"b_{tag}"), b_csv,
        resolution=(MC_RES, MC_RES), batch_size=2, mesh=mesh, device=DEV,
        verbose=False, **kw) for tag, kw in (
            ("det", {}), ("mc", dict(mc_spp=MC_SPP, mc_majorant_cell=16)))}
    stage_b_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage_c = {mode: build_velocity_maps(
        c_root, os.path.join(workdir, f"c_{mode}"), c_csv, mode=mode,
        resolution=(256, 256), slice_height_m=C_SLICE_M,
        batch_size=C_BATCH, mesh=mesh, device=DEV, verbose=False)
        for mode in ("slice", "first_hit")}
    return {"multi": multi, "sp": sp, "stage_b": stage_b,
            "stage_b_s": stage_b_s, "stage_c": stage_c,
            "stage_c_s": time.perf_counter() - t0}


def _gloo_p2p_rank(mesh):
    """gloo's own send and receive of a CUDA tensor (the port stages it
    through the host instead): does the received tensor hold the sender's
    values?"""
    torch.cuda.set_device(0)
    src = torch.full((1024,), float(mesh.rank + 1), device=DEV)
    buf = torch.zeros_like(src)
    peer = 1 - mesh.rank
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer),
                                    dist.P2POp(dist.irecv, buf, peer)])
    for w in works:
        w.wait()
    torch.cuda.synchronize()
    return bool((buf == peer + 1).all())


def _gloo_p2p_cuda():
    """Run ``_gloo_p2p_rank`` on two ranks: "ok", or what went wrong
    (recorded: the port does not depend on it)."""
    try:
        got = run_local_ranks(_gloo_p2p_rank, MESH_RANKS, backend="gloo",
                              timeout_s=90, group_timeout_s=30)
        return "ok" if all(got) else "received wrong values"
    except Exception as e:   # recorded; the port's ring stages via the host
        return f"{type(e).__name__}: {str(e).strip().splitlines()[-1][:200]}"


def _torchrun_cli(workdir):
    """``gen-renders`` and ``gen-maps --data-parallel`` under torchrun with
    two CPU ranks on a small geometry, against one process's --batch 2:
    {command: byte-equal}."""
    root = os.path.join(workdir, "t_patches")
    os.makedirs(os.path.join(root, f"{1:010d}"))
    beta = np.zeros((10, 16, 16), np.float32)
    beta[4:8, 4:12, 4:12] = 0.05
    for i in range(3):
        with open(os.path.join(root, f"{1:010d}", f"sample_00{i}.pkl"),
                  "wb") as f:
            b = np.roll(beta, i, axis=1)
            pickle.dump({"beta_ext": b, "U": b, "V": -b, "W": b + 1.0}, f)
    csv = synthesize_overpass_csv(os.path.join(workdir, "t.csv"),
                                  n_times=1, n_satellites=2)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = {}
    for cmd, extra in (("gen-renders", ["--fov", "0.01"]),
                       ("gen-maps", ["--slice-height", "80"])):
        args = [cmd, "--input", root, "--csv", csv, "--res", "12",
                "--device", "cpu", *extra]
        one = os.path.join(workdir, f"t_{cmd}_one")
        with contextlib.redirect_stdout(sys.stderr):
            cli_main(args + ["--output", one, "--batch", "2"])
        dp = os.path.join(workdir, f"t_{cmd}_dp")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(MESH_RANKS), "-m",
             "unet_convlstm_tpu_torch", *args, "--output", dp,
             "--data-parallel"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=180)
        out[cmd] = {"rc": r.returncode,
                    "wall_s": time.perf_counter() - t0,
                    "stdout": r.stdout.strip().splitlines()[-1:],
                    "stderr_tail": r.stderr.strip().splitlines()[-3:],
                    "byte_equal": r.returncode == 0
                    and _raw(dp) == _raw(one)}
    return out


def phase_mesh(workdir: str, mc_batch_pkls: dict):
    """The rest of the mesh surface: K steps a call, remat and the flat
    layouts in one process; then two gloo ranks sharing cuda:0 run the
    multi-step, the pipelined ConvLSTM and stages B and C over the ranks;
    the CLI's --data-parallel. ``mc_batch_pkls``: phase 7's batched MC
    pkls. Returns the launches of the one-process runs."""
    t_phase = time.perf_counter()
    tr = _Train()
    multi = _multi_vs_single(tr, None, MULTI_K)
    expect = on_main_routes({"gate_update": K1_PER_STEP * MULTI_K,
                             "gate_update_bwd": K1_PER_STEP * MULTI_K,
                             "conv3x3_fused": K2_PER_STEP * MULTI_K,
                             **NO_LAUNCHES})
    multi.pop("bits")
    line = {"phase": "mesh", "check": "multi_step", "B": TB, "T": TT,
            "H": THW, "base_ch": TBASE, "dtype": "bfloat16", **multi,
            "expected": expect, "counts_ok": multi["counts"] == expect
            and multi["single_counts"] == expect}
    line["ok"] = line["bit_equal"] and line["counts_ok"]
    emit(line)
    lines = [line]
    lines.append(mesh_remat_layout(tr))
    del tr
    torch.cuda.empty_cache()

    # the inputs of stages B and C, and one process's pkls of each
    b_root, b_csv = render_tree(os.path.join(workdir, "b"))
    c_root = os.path.join(workdir, "c_patches")
    cloud_gate.synthesize_cloud_patches(
        c_root, dataclasses.replace(GATE, n_folders=1))
    c_csv = synthesize_overpass_csv(os.path.join(workdir, "c_overpass.csv"),
                                    n_times=1, n_satellites=2)
    one = {}
    for tag, extra in (("det", []), ("det_dp", ["--data-parallel"])):
        dst = os.path.join(workdir, f"one_b_{tag}")
        with contextlib.redirect_stdout(sys.stderr):
            cli_main(["gen-renders", "--input", b_root, "--csv", b_csv,
                      "--res", str(MC_RES), "--batch", "2", "--output", dst,
                      *extra])
        one[tag] = _raw(dst)
    c_base = ["--input", c_root, "--csv", c_csv, "--res", "256",
              "--slice-height", str(C_SLICE_M), "--batch", str(C_BATCH)]
    for mode in ("slice", "first_hit"):
        for tag, extra in (("", []), ("_dp", ["--data-parallel"])):
            dst = os.path.join(workdir, f"one_c_{mode}{tag}")
            _gen_maps(c_base + ["--mode", mode] + extra, dst)
            one[f"c_{mode}{tag}"] = _raw(dst)

    ranks_dir = os.path.join(workdir, "ranks")
    os.makedirs(ranks_dir)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_local_ranks(_mesh_rank, MESH_RANKS,
                            (ranks_dir, ((b_root, b_csv), (c_root, c_csv))),
                            backend="gloo", timeout_s=600,
                            group_timeout_s=300)
    ranks_wall = time.perf_counter() - t0

    # (a) on the ranks
    r0 = ranks[0]["multi"]
    rank_expect = on_main_routes({
        "gate_update": K1_PER_STEP * MULTI_K_RANKS,
        "gate_update_bwd": K1_PER_STEP * MULTI_K_RANKS,
        "conv3x3_fused": K2_PER_STEP * MULTI_K_RANKS, **NO_LAUNCHES})
    line = {"phase": "mesh", "check": "multi_step_ranks",
            "ranks": MESH_RANKS, "backend": "gloo",
            "device": "cuda:0 shared", "rows_per_rank": TB // MESH_RANKS,
            "k": MULTI_K_RANKS,
            "bit_equal_single_steps": [r["multi"]["bit_equal"]
                                       for r in ranks],
            "ranks_same_bits": all(r["multi"]["bits"] == r0["bits"]
                                   for r in ranks),
            "losses": r0["losses"],
            "launches_per_rank": [r["multi"]["counts"] for r in ranks],
            "expected": rank_expect,
            "multi_wall_ms": [r["multi"]["multi_wall_ms"] for r in ranks],
            "single_wall_ms": [r["multi"]["single_wall_ms"] for r in ranks],
            "note": "processes sharing one card: no data-parallel speed"}
    line["ok"] = (all(line["bit_equal_single_steps"])
                  and line["ranks_same_bits"]
                  and all(c == rank_expect
                          for c in line["launches_per_rank"]))
    emit(line)
    lines.append(line)

    # (c) the pipelined ConvLSTM
    sp0 = ranks[0]["sp"]
    sp_cases = []
    sp_ok = True
    for key, case in sp0.items():
        tag, T, M = key
        c = dict(case, dtype=tag, T=T, microbatches=M,
                 k1_per_rank=[r["sp"][key]["k1"] for r in ranks],
                 k1_expected=[r["sp"][key]["k1_expected"] for r in ranks],
                 ranks_same_bits=all(r["sp"][key]["digests"]
                                     == case["digests"] for r in ranks))
        c.pop("digests")
        if tag == "f32":
            c["ok"] = c["max_excess"] <= 0
        else:
            c["ok"] = all(a <= SP_BF16_RATIO * b for a, b in zip(
                c["rms_vs_f32"], c["one_process_rms_vs_f32"]))
        c["ok"] = (c["ok"] and c["ranks_same_bits"]
                   and c["k1_per_rank"] == c["k1_expected"]
                   and c["shapes"] == [[T, TB, THW // 16, THW // 16,
                                        16 * TBASE]] + [
                       [TB, THW // 16, THW // 16, 16 * TBASE]] * 2)
        sp_ok = sp_ok and c["ok"]
        sp_cases.append(c)
    line = {"phase": "mesh", "check": "pipelined_convlstm",
            "ranks": MESH_RANKS, "axis": "data", "layer": "temporal",
            "channels": [16 * TBASE, 16 * TBASE], "side": THW // 16,
            "B": TB, "cases": sp_cases, "ok": sp_ok}
    emit(line)
    lines.append(line)

    # (d), (e) stages B and C over the ranks against one process
    got_b = {tag: _raw(os.path.join(ranks_dir, f"b_{tag}"))
             for tag in ("det", "mc")}
    got_c = {mode: _raw(os.path.join(ranks_dir, f"c_{mode}"))
             for mode in ("slice", "first_hit")}
    line = {"phase": "mesh", "check": "datagen_ranks", "ranks": MESH_RANKS,
            "stage_b": {"patch": [MC_NZ, MC_NXY, MC_NXY], "res": MC_RES,
                        "spp": MC_SPP, "pkls": {t: len(v) for t, v in
                                                got_b.items()},
                        "det_byte_equal": got_b["det"] == one["det"],
                        "mc_byte_equal_phase7": got_b["mc"] == mc_batch_pkls,
                        "counts": [r["stage_b"] for r in ranks],
                        "wall_s": [r["stage_b_s"] for r in ranks]},
            "stage_c": {"patch": [GATE.nz, GATE.nxy, GATE.nxy], "res": 256,
                        "batch": C_BATCH,
                        "byte_equal": {m: got_c[m] == one[f"c_{m}"]
                                       for m in got_c},
                        "pkls": {m: len(v) for m, v in got_c.items()},
                        "counts": [r["stage_c"] for r in ranks],
                        "wall_s": [r["stage_c_s"] for r in ranks]}}
    line["ok"] = (line["stage_b"]["det_byte_equal"]
                  and line["stage_b"]["mc_byte_equal_phase7"]
                  and len(got_b["det"]) == 4
                  and all(r["stage_b"] == {"det": 4, "mc": 4}
                          for r in ranks)
                  and all(line["stage_c"]["byte_equal"].values())
                  and all(r["stage_c"] == {m: 2 * GATE.n_samples
                                           for m in got_c} for r in ranks))
    emit(line)
    lines.append(line)

    # (f) the CLI: --data-parallel in one process, and under torchrun
    torchrun = _torchrun_cli(workdir)
    line = {"phase": "mesh", "check": "cli_data_parallel",
            "one_process_equals_batch": {
                "gen-renders": one["det_dp"] == one["det"],
                **{f"gen-maps {m}": one[f"c_{m}_dp"] == one[f"c_{m}"]
                   for m in ("slice", "first_hit")}},
            "torchrun_cpu_ranks": torchrun}
    line["ok"] = (all(line["one_process_equals_batch"].values())
                  and all(v["byte_equal"] for v in torchrun.values()))
    emit(line)
    lines.append(line)

    summary = {"phase": "mesh_summary",
               "checks": [ln["check"] for ln in lines],
               "ok": [ln["ok"] for ln in lines],
               "gloo_p2p_cuda": _gloo_p2p_cuda(),
               "ranks_wall_s": ranks_wall,
               "phase_wall_s": time.perf_counter() - t_phase,
               "note": "processes sharing one card: no parallel speed; "
                       "multi-rank NCCL unverified (one card)"}
    emit(summary)
    if not all(summary["ok"]):
        raise AssertionError("the mesh surface on the card failed")
    rl = lines[1]["launches"]
    return {name: {"multi_step_k4": multi["counts"][name],
                   "remat_step": rl["remat"][name],
                   "pipelined_convlstm_rank0": sum(
                       c["k1_per_rank"][0] for c in sp_cases)
                   if name == "gate_update" else 0}
            for name in ("gate_update", "gate_update_bwd", "conv3x3_fused")}


# ---------------------------------------------------------------------------
# 20. the examples and run drivers, and the rbg stream
# ---------------------------------------------------------------------------

DRIVER_TIMEOUT_S = 600
DRIVER_PKG = "unet_convlstm_tpu_torch"
RBG_SE_LIMIT = MC_SE_LIMIT
DRIVERS_TOL = ("each driver exits 0 with its verdict line; K1 and K2 "
               "launches exact (the endurance run's killed child excepted: "
               "it is killed before it reports); the quickstart's "
               "evaluation MAE equal to its best epoch's val MAE to the 6 "
               "printed decimals; the rbg uniforms on the card bit-equal "
               "to the CPU's; rbg views' means within "
               f"{RBG_SE_LIMIT} standard errors of the threefry view's")


def _fit_launches(npz, batch, k1_per_frame, k2_per_pass, epochs=1):
    """A fit's K1 forward, backward and K2 launches: per train step and
    eval batch of the 0.8 / seed-42 split, K1 k1_per_frame a frame."""
    ds = NPZSequenceDataset(npz)
    tr, va = ds.train_val_split(0.8, 42)
    steps, evals = len(tr) // batch, math.ceil(len(va) / batch)
    k1 = k1_per_frame * ds.T
    return {"gate_update": (steps + evals) * k1 * epochs,
            "gate_update_bwd": steps * k1 * epochs,
            "conv3x3_fused": (steps + evals) * k2_per_pass * epochs}


def _add(*counts):
    return {k: sum(c.get(k, 0) for c in counts)
            for k in ("gate_update", "gate_update_bwd", "conv3x3_fused")}


def _gate_npz(work):
    with open(os.path.join(work, "gate_dataset.json")) as f:
        return json.load(f)["npz"]


def _drivers(wd):
    """(name, module, argv) of each driver, cut to seconds; the model
    widths are the drivers' own."""
    return [
        ("library_quickstart", "examples.library_quickstart",
         ["--work-dir", os.path.join(wd, "qs")]),
        ("render_one", "examples.render_one",
         ["--res", "64", "--out-dir", os.path.join(wd, "r1")]),
        ("run_resnet_golden", "scripts.run_resnet_golden",
         ["--npz", os.path.join(wd, "rg.npz"), "--out",
          os.path.join(wd, "rg.json"), "--samples", "40", "--epochs", "1"]),
        ("pretrain_encoder", "scripts.pretrain_encoder",
         ["--work-dir", os.path.join(wd, "pt"), "--epochs", "1",
          "--n-folders", "12", "--n-samples", "6", "--out",
          os.path.join(wd, "pt.pth"), "--result-json",
          os.path.join(wd, "pt.json")]),
        ("run_mnist_T40", "scripts.run_mnist_T40",
         ["--samples", "32", "--epochs", "2", "--epochs-per-proc", "1",
          "--npz", os.path.join(wd, "t40.npz"), "--out",
          os.path.join(wd, "t40.json")]),
        ("run_endurance_200ep", "scripts.run_endurance_200ep",
         ["--work-dir", os.path.join(wd, "en"), "--epochs", "4",
          "--kill-at", "2", "--save-every", "1", "--out",
          os.path.join(wd, "en.json")]),
    ]


def _k2_per_pass(base, hw):
    """K2's launches in one pass of the custom model: the fused convs of
    ``k2_convs`` whose input and output are both at least 16 channels
    wide (``ops/blocks.double_conv``: narrower convs are library convs)."""
    return sum(n for _, cin, cout, _, n in k2_convs(base, hw)
               if min(cin, cout) >= 16)


def _driver_checks(name, wd, out):
    """(expected K1/K2 launches, checks, record) of one driver's run."""
    k2_custom = _k2_per_pass(8, 64)
    custom_frame = len(k1_levels(8, 64, 1))        # K1 launches a frame
    lines = out.splitlines()
    if name == "library_quickstart":
        npz = os.path.join(wd, "qs", "mm.npz")
        ds = NPZSequenceDataset(npz)
        n_val = len(ds.train_val_split(0.8, 42)[1])
        pass_ = {"gate_update": custom_frame * ds.T,
                 "conv3x3_fused": k2_custom}
        expect = _add(_fit_launches(npz, 16, custom_frame, k2_custom, 2),
                      *[pass_] * math.ceil(n_val / 16),    # evaluate_model
                      {"gate_update": custom_frame * ds.T,  # streaming
                       "conv3x3_fused": k2_custom * ds.T})
        mae = next(ln for ln in lines if ln.startswith("val MAE "))
        rec = {"val_mae_line": mae}
        checks = {"last_line": lines[-1] == "QUICKSTART_OK",
                  "mae_equals_best_epoch": mae.split()[2]
                  == mae.rsplit("val MAE ", 1)[1].rstrip(")")}
    elif name == "render_one":
        expect = _add()
        with np.load(os.path.join(wd, "r1", "views.npz")) as f:
            views, warped = f["views"], f["warped"]
        align = next(ln for ln in lines if ln.startswith("alignment: "))
        rec = {"views": list(views.shape), "alignment_line": align,
               "figures": next(ln for ln in lines
                               if ln.startswith("figures"))}
        checks = {"views_finite_lit": bool(np.isfinite(views).all()
                                           and (views.max(axis=(1, 2))
                                                > 0).all()),
                  "warped_finite": bool(np.isfinite(warped).all()),
                  "alignment_finite": math.isfinite(float(
                      align.split("= ")[1].split()[0]))}
    elif name == "run_resnet_golden":
        with open(os.path.join(wd, "rg.json")) as f:
            rec = {k: v for k, v in json.load(f).items() if k != "history"}
        expect = _fit_launches(os.path.join(wd, "rg.npz"), 16, 5, 0)
        checks = {"val_mae_finite": math.isfinite(rec["val_mae"]),
                  "encoder_trained": rec["encoder_frozen"] is False}
    elif name == "pretrain_encoder":
        with open(os.path.join(wd, "pt.json")) as f:
            rec = json.load(f)
        expect = _fit_launches(_gate_npz(os.path.join(wd, "pt")), 4, 10, 0)
        checks = {"encoder_equals_checkpoint":
                  rec["encoder_equals_checkpoint"],
                  "frozen_on_pth": rec["frozen_on_pth"]}
    elif name == "run_mnist_T40":
        npz = os.path.join(wd, "t40.npz")
        with open(os.path.join(wd, "t40.json")) as f:
            rec = {k: v for k, v in json.load(f).items() if k != "history"}
        k2_t40 = _k2_per_pass(32, 64)
        expect = _add(_fit_launches(npz, 16, custom_frame, k2_t40, 2),
                      {"gate_update": custom_frame * 40,     # rollout_scan
                       "conv3x3_fused": k2_t40})
        checks = {"two_generations": rec["process_generations"] == 2,
                  "rollout_finite": math.isfinite(rec["rollout_psnr_db"])
                  and math.isfinite(rec["rollout_ssim"])}
    else:
        with open(os.path.join(wd, "en.json")) as f:
            rec = json.load(f)
        per_epoch = _fit_launches(_gate_npz(os.path.join(wd, "en")), 4, 10,
                                  0)
        resumed = rec["epochs_logged"] - rec["sigkill_after_epoch"]
        expect = _add(per_epoch, *[per_epoch] * resumed)
        checks = {"endurance_ok": lines[-1] == "[endure] ENDURANCE_OK",
                  "seam_ok": rec["resume_seam_ok"],
                  "replay_within_one_period": rec["resume_replayed_epochs"]
                  <= rec["save_last_every"] + 1}
        rec = {k: v for k, v in rec.items() if k != "lr_trajectory"}
    return expect, checks, rec


def phase_drivers_runs(wd):
    """Every driver through ``python -m`` with no --device (the card), all
    six at once; each prints its launches (its child processes'
    included). Returns the K1/K2 launches summed over the drivers."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {}
    t0 = time.perf_counter()
    for name, module, argv in _drivers(wd):
        log = open(os.path.join(wd, f"{name}.out"), "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", f"{DRIVER_PKG}.{module}", *argv],
            cwd=wd, env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True), log, module, argv)
    total, ok = _add(), True
    for name, (p, log, module, argv) in procs.items():
        try:
            rc = p.wait(timeout=max(1.0, DRIVER_TIMEOUT_S
                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        wall = time.perf_counter() - t0
        log.close()
        with open(os.path.join(wd, f"{name}.out")) as f:
            out = f.read()
        line = {"phase": "drivers", "driver": name,
                "command": f"python -m {DRIVER_PKG}.{module} "
                           + " ".join(argv), "exit_code": rc,
                "done_after_s": wall}
        try:
            launches = [ln for ln in out.splitlines()
                        if ln.startswith("launches ")]
            counts = json.loads(launches[-1].split(" ", 1)[1])
            expect, checks, rec = _driver_checks(name, wd, out)
            got = {k: counts[k] for k in expect}
            line.update(launches=got, expected=expect, checks=checks,
                        result=rec, other_launches={
                            k: v for k, v in counts.items()
                            if k not in expect and v})
            line["ok"] = (rc == 0 and got == expect
                          and all(checks.values())
                          and not line["other_launches"])
            total = _add(total, got)
        except (IndexError, KeyError, OSError, ValueError,
                StopIteration) as e:
            line.update(ok=False, error=repr(e))
        if not line["ok"]:
            line["output_tail"] = out[-3000:]
        emit(line)
        ok = ok and line["ok"]
    if not ok:
        raise AssertionError("a driver failed")
    return total


def phase_drivers_rbg():
    """The rbg stream on the card: uniforms bit-equal to the CPU's; one
    view at phase 6's geometry (the dense patch at its auto cell) on the
    threefry chain and on the fused route against the threefry view.
    Returns the fused view's K4 launches."""
    keys = rnd.split(rnd.rbg_key(SEED), MC_SPP)
    card = rnd.uniform(keys.to(DEV), MC_LANES).cpu()
    cpu = rnd.uniform(keys, MC_LANES)
    carry = torch.tensor([[5, 9, 2 ** 32 - 1, 2 ** 32 - 1],
                          [2 ** 32 - 1, 7, 2 ** 32 - 5, 2 ** 32 - 1]])
    raw_equal = torch.equal(rnd.xla_philox_bits(carry.to(DEV), 4099).cpu(),
                            rnd.xla_philox_bits(carry, 4099))
    line = {"phase": "rbg_bits", "keys": MC_SPP, "uniforms": MC_LANES,
            "bit_equal": torch.equal(card.view(torch.int32),
                                     cpu.view(torch.int32)),
            "raw_bits_with_carries_equal": raw_equal,
            "in_unit_interval": bool((card >= 0).all() and (card < 1).all())}
    line["ok"] = all(line[k] for k in ("bit_equal",
                                       "raw_bits_with_carries_equal",
                                       "in_unit_interval"))
    emit(line)
    beta = mc_patches()["dense"]
    scene = VolumeScene(torch.from_numpy(beta).to(DEV), 20.0)
    sun = np.asarray(MC_CAMERA["sun_dir"], np.float32)
    t_sun = sun_transmittance(scene, sun / np.linalg.norm(sun))
    cell = mc_reference.auto_majorant_cell(float(beta.max()), scene.diagonal)
    views, ok = {}, line["ok"]
    for rng_impl, fused in (("threefry", False), ("rbg", False),
                            ("rbg", True)):
        img, wall, stats, counts = _mc_view(scene, t_sun, cell, fused,
                                            rng_impl=rng_impl)
        rm = np.asarray(stats["round_means"])[:, 0]
        expect = dict({k: 0 for k in counts}, mc_sample_flights=(
            stats["iterations"] if fused else 0))
        v = {"phase": "rbg_view", "patch": "dense", "rng_impl": rng_impl,
             "route": "fused" if fused else "threefry_chain",
             "majorant_cell": cell, "spp": MC_SPP, "wall_s": wall,
             "iterations": stats["iterations"], "launches": counts,
             "expected": expect, "mean": float(img.mean()),
             "se": float(rm.std(ddof=1) / np.sqrt(len(rm))),
             "finite": bool(torch.isfinite(img).all()),
             "nonnegative": bool((img >= 0).all())}
        ref = views.get(("threefry", False))
        if ref is not None:
            v["z_vs_threefry"] = abs(v["mean"] - ref["mean"]) / max(
                math.hypot(v["se"], ref["se"]), 1e-30)
        v["ok"] = (counts == expect and v["finite"] and v["nonnegative"]
                   and v.get("z_vs_threefry", 0.0) <= RBG_SE_LIMIT)
        emit(v)
        views[rng_impl, fused] = v
        ok = ok and v["ok"]
    if not ok:
        raise AssertionError("the rbg stream on the card failed")
    return views["rbg", True]["launches"]["mc_sample_flights"]


def phase_drivers(workdir: str):
    """Phase 20: the drivers, then the rbg stream. Returns the drivers'
    K1/K2 launches and the rbg fused view's K4 launches."""
    t0 = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    counts = phase_drivers_runs(workdir)
    k4 = phase_drivers_rbg()
    emit({"phase": "drivers_summary", "launches": counts,
          "rbg_mc_sample_flights": k4,
          "phase_wall_s": time.perf_counter() - t0, "ok": True})
    return counts, k4


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = phase_device()
    emit({"phase": "tolerances", "gate_update": K1_TOL,
          "gate_update_bwd": K1_BWD_TOL, "conv3x3_fused": K2_TOL,
          "conv3x3_fused_f32": K2_F32_TOL,
          "conv3x3_fused_rerun": K2_RERUN_TOL,
          "train_f32": ("loss, metric sums 1e-4 relative; first gradients "
                        "1e-3 of their norm; params after a step: at most "
                        "0.5% of elements off by more than lr/2, the rest "
                        "5e-2 RMS in units of lr; BN running stats 1e-4 of "
                        "max(1, max|stat|) (each step from the same state)"),
          "train_bf16": "first forward and gradients: the kernel path no "
                        "further from f32 than 1.25x the plain path",
          "mc_sample_flights": MC_K_TOL, "mc_card_vs_cpu": MC_CROSS_TOL,
          "mc_fused_vs_threefry": f"image means within {MC_SE_LIMIT} "
                                  "standard errors (from the per-round "
                                  "means)",
          "gen_renders": "batched = serial within 1e-6 relative; a re-run "
                         "byte-equal",
          "channel_sum_sumsq": K6_TOL, "chained_gather": K7_TOL,
          "fit": "launch counts exact per epoch; the resume runs one "
                 "epoch; losses finite; one served request finite",
          "overfit": "chunk losses finite, each below the first, the last "
                     "the lowest",
          "resnet": "K1 lines as gate_update and gate_update_bwd; serving "
                    "as serve_checks; training: the first forward and "
                    "gradients as train_f32 and train_bf16; launch counts "
                    "exact; the frozen encoder bit-equal",
          "conv_int8": K8_TOL,
          "microphysics": f"{MICRO_TOL} relative: {MICRO_TOL_WHY}",
          "stage_c": (f"card against CPU: at most {C_TOL} of the pixels "
                      f"differ ({C_TOL_WHY}); --batch 8 equal to serial"),
          "cloud_gate": (f"PASSED: best val MAE < {GATE.mae_threshold} and "
                         "below the first epoch's; launch counts exact"),
          "eval": ("evaluate's printed MAE equal to the best epoch's val MAE "
                   "to 4 decimals; launch counts exact; rollouts in f32: "
                   f"whole-sequence against streaming {SCAN_F32_TOL} RMS "
                   "(outputs and final states, same dtypes), each prefix "
                   f"re-run's last frame {PREFIX_F32_TOL} RMS"),
          "int8": ("launch counts exact, no K2; the int8 forward with K8 "
                   f"against K8's plain version {INT8_PLAIN_TOL} RMS in f32 "
                   "and bit-equal in bf16; int8 against bf16 below "
                   f"{INT8_PTQ_BOUND} relative L2 with BatchNorm at init "
                   "(the JAX test's condition; with calibrated BatchNorm "
                   "reported); every site calibrated; HTTP 1e-6; evaluate "
                   "--int8 on the training run's checkpoint: dynamic int8 "
                   "with K8 equal to it with K8's plain version (1e-6), "
                   f"calibrated at most {INT8_EVAL_SANITY}x the bf16 MAE "
                   "(the ratio reported against BASELINE.md's 10%)"),
          "surface": SURFACE_TOL,
          "repro": ("K2's y, sum and sumsq over 20 launches, the training "
                    "steps run twice, the production gate run twice: "
                    "bit-equal"),
          "dp": DP_TOL_WHY, "tp": TP_TOL_WHY, "mesh": MESH_TOL_WHY,
          "drivers": DRIVERS_TOL})
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    k1 = check_k1(gen, K1_LEVELS, B, "request")
    k1_edges = check_k1_edges(gen)
    k2 = check_k2(gen, K2_CONVS, B * T, "request", serving=True)
    k2_b1 = check_k2_edges(gen)
    k1_bwd = check_k1_bwd(gen)
    k1_train = check_k1(gen, K1_TRAIN_LEVELS, TB, "step")
    k2_train = check_k2(gen, K2_TRAIN_CONVS, TB * TT, "step", serving=False)
    mc_k = check_mc_kernels(gen)
    k6 = check_k6(gen)
    k7 = check_k7(gen)
    k8 = check_k8(gen, K8_CUSTOM, "int8_forward")
    k8_resnet = check_k8(gen, K8_RESNET, "resnet_int8_request")
    k8_ragged = check_k8(gen, K8_RAGGED, "ragged", timed=False)
    check_k8_offset(gen)
    with tempfile.TemporaryDirectory() as workdir:
        pred, counts = phase_serve(workdir)
    phase_latency(pred)
    del pred
    torch.cuda.empty_cache()
    train_counts, _ = phase_train(_Train())
    torch.cuda.empty_cache()
    k4_launches, k4_iters, _ = phase_mc()
    with tempfile.TemporaryDirectory() as workdir:
        mc_batch_pkls = phase_renders(workdir)
    probe_counts = phase_probes()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        npz, fit_counts = phase_fit(workdir)
        torch.cuda.empty_cache()
        phase_overfit(npz, workdir)
        torch.cuda.empty_cache()
        resnet = phase_resnet(workdir, npz)
        torch.cuda.empty_cache()
        bf16_mae, _ = phase_eval(workdir, npz)
        torch.cuda.empty_cache()
        int8_counts = phase_int8(workdir, npz, bf16_mae,
                                 os.path.join(workdir, "resnet18.pt"), smi)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as chaindir:
            chain_counts, gate = phase_datachain(chaindir)
            torch.cuda.empty_cache()
            surface_counts = phase_surface(workdir, npz, chaindir)
        torch.cuda.empty_cache()
        phase_repro(gen, gate)
        torch.cuda.empty_cache()
        dp_counts = phase_dp(workdir)
        torch.cuda.empty_cache()
        tp_counts, k2_tp = phase_tp(workdir, gen)
        torch.cuda.empty_cache()
        mesh_counts = phase_mesh(workdir, mc_batch_pkls)
        torch.cuda.empty_cache()
        driver_counts, rbg_k4 = phase_drivers(
            os.path.join(workdir, "drivers"))

    per = f"one request: B={B}, T={T}, {HW}x{HW}, base_ch {BASE}, bf16"
    per_step = (f"one training step: B={TB}, T={TT}, {THW}x{THW}, base_ch "
                f"{TBASE}, bf16")

    def train_part(name, t):
        return {"launches": train_counts[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "library_ms": t.get("library_ms"), "per": per_step}

    def k2_bound_by(t):
        return "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"

    kernels = [
        {"name": "gate_update", "route": "cuda",
         "source": "unet_convlstm_tpu_torch/csrc/gate_update.cu",
         "replaces": "unet_convlstm_tpu/ops/pallas/convlstm_fused.py:44",
         "launches": counts["gate_update"],
         "launches_per_request": K1_PER_REQUEST,
         "launches_by_route": {r: counts[f"gate_update_{r}"]
                               for r in convlstm_fused.ROUTES},
         "redesigned": 6,
         "max_abs_err": max(k1["max_abs_err"], k1_train["max_abs_err"],
                            k1_edges),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "per": per, "train": train_part("gate_update", k1_train)},
        {"name": "conv3x3_fused", "route": "cuda",
         "source": "unet_convlstm_tpu_torch/csrc/conv3x3_fused.cu",
         "replaces": "unet_convlstm_tpu/ops/pallas/doubleconv_fused.py:100",
         "launches": counts["conv3x3_fused"],
         "launches_per_request": K2_PER_REQUEST,
         "max_abs_err": max(k2["max_abs_err"], k2_train["max_abs_err"],
                            k2_b1["max_abs_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2_bound_by(k2),
         "library_ms": k2["library_ms"], "per": per,
         "launches_by_route": {r: counts[f"conv3x3_fused_{r}"]
                               for r in doubleconv_fused.ROUTES},
         "train": dict(train_part("conv3x3_fused", k2_train),
                       bound_by=k2_bound_by(k2_train)),
         "tp_cout_half": {
             f"rows_{TB // d}": dict(
                 {k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "max_abs_err")},
                 bound_by=k2_bound_by(t),
                 per=f"one rank's step of a ({d}, {TP_MODEL}) mesh: "
                     f"{TB // d} rows, T={TT}, {THW}x{THW}, base_ch "
                     f"{TBASE}, Cout/{TP_MODEL}, bf16")
             for d, t in k2_tp.items()},
         "request_b1t1": dict(k2_b1, bound_by=k2_bound_by(k2_b1),
                              per=f"one request: B=1, T=1, {HW}x{HW}, "
                                  f"base_ch {BASE}, bf16")},
        {"name": "gate_update_bwd", "route": "cuda",
         "source": "unet_convlstm_tpu_torch/csrc/gate_update_bwd.cu",
         "replaces": "unet_convlstm_tpu/ops/pallas/convlstm_fused.py:56",
         "launches": train_counts["gate_update_bwd"],
         "launches_per_step": K1_PER_STEP,
         "max_abs_err": k1_bwd["max_abs_err"], "ms": k1_bwd["ms"],
         "plain_ms": k1_bwd["plain_ms"], "bound_ms": k1_bwd["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "per": per_step},
    ]
    mc_per = (f"one launch of the MC main path: {MC_SPP} rounds x "
              f"{MC_LANES} lanes (a {MC_RES}x{MC_RES} view at spp {MC_SPP}),"
              " g 0.85")
    for name, replaces, launches in (
            ("mc_sample_flights", "mc_sampler.py:86", k4_launches),
            ("mc_sample_flights_uniforms", "mc_sampler.py:105", 0)):
        t, view = mc_k[name, MC_SPP], mc_k[name, 1]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "unet_convlstm_tpu_torch/csrc/mc_sampler.cu",
            "replaces": f"unet_convlstm_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": max(t["max_abs_err"],
                                                     view["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "per": mc_per,
            "view_lanes": {"lanes": MC_LANES, "ms": view["ms"],
                           "plain_ms": view["plain_ms"],
                           "bound_ms": view["bound_ms"]}})
    kernels[-2]["lockstep_iterations"] = k4_iters
    kernels[-1]["note"] = ("the exact-parity entry point (uniforms given), "
                           "which holds K4's math; the render path draws "
                           "its uniforms in K4 and does not launch it")
    for k in kernels[:3]:
        k["fit_launches"] = fit_counts[k["name"]]
        k["datachain_launches"] = chain_counts[k["name"]]
        k["dp_launches_per_rank_per_step"] = dp_counts[k["name"]]
        k["tp_launches_per_rank_per_step"] = tp_counts[k["name"]]
        k["mesh_launches"] = mesh_counts[k["name"]]
        k["drivers_launches"] = driver_counts[k["name"]]
    kernels[3]["datachain_launches"] = chain_counts["mc_sample_flights"]
    kernels[3]["rbg_launches"] = rbg_k4
    kernels[0]["resnet"] = resnet["gate_update"]
    kernels[2]["resnet"] = resnet["gate_update_bwd"]
    kernels.append({
        "name": "channel_sum_sumsq", "route": "cuda",
        "source": "unet_convlstm_tpu_torch/csrc/channel_stats.cu",
        "replaces": "scripts/perf/bn_kernel_proto.py:46",
        "launches": probe_counts["channel_sum_sumsq"],
        "max_abs_err": k6["max_abs_err"], "ms": k6["ms"],
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"], "library_ms": k6["library_ms"],
        "library": "torch.batch_norm_stats on the channels-last view",
        "per": "one call at the BN probe's activation [640, 64, 64, 32] "
               "bf16; max_abs_err is the means'"})
    head = next(v for v in k7 if v["shape"] == [512, 128]
                and v["axis"] == 0)
    kernels.append({
        "name": "chained_gather", "route": "cuda",
        "source": "unet_convlstm_tpu_torch/csrc/chained_gather.cu",
        "replaces": "scripts/perf/probe_pallas_gather.py:33",
        "launches": probe_counts["chained_gather"], "max_abs_err": 0.0,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library": "torch.gather, one link (reps 1)",
        "redesigned": 6, "plan": head["plan"],
        "launch_floor_ms": head["launch_floor_ms"],
        "latency_floor_ms": head["latency_floor_ms"],
        "per": f"one launch of variant C, (512, 128) axis 0, reps "
               f"{probe_gather.REPS}",
        "variants": [{k: v[k] for k in ("variant", "ms", "plain_ms",
                                        "library_ms", "bound_ms")}
                     for v in k7]})
    kernels.append({
        "name": "conv_int8", "route": "cuda",
        "source": "unet_convlstm_tpu_torch/csrc/conv_int8.cu",
        "replaces": "unet_convlstm_tpu/ops/quant.py:215",
        "note": ("no Pallas counterpart: XLA's int8 conv_general_dilated "
                 "(quant.py:215-227, transposed :259-271)"),
        "launches": int8_counts["conv_int8"],
        "launches_per_forward": K8_PER_FORWARD,
        "launches_by_route": {r: int8_counts[f"conv_int8_{r}"]
                              for r in conv_int8.ROUTES},
        "launches_by_entry": {e: int8_counts[f"conv_int8_{e}_entry"]
                              for e in conv_int8.ENTRIES},
        "redesigned": 9,
        "max_abs_err": max(k8["max_abs_err"], k8_resnet["max_abs_err"],
                           k8_ragged["max_abs_err"]),
        "ms": k8["ms"], "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound_ms"],
        "bound_by": "operations" if k8["ops_ms"] >= k8["bytes_ms"]
        else "bytes",
        "library_ms": None,
        "library": "none: PyTorch has no int8 convolution on CUDA",
        "ms_dynamic": k8["ms_dynamic"], "ms_int8_input": k8["ms_int8_input"],
        "bound_ms_int8_input": k8["bound_ms_int8_input"],
        "cudnn_bf16_ms": k8["cudnn_bf16_ms"],
        "cudnn_bf16": ("cuDNN's bf16 convs at the same shapes: a reference "
                       "point (the float path int8 replaces), not the same "
                       "function"),
        "int_mm_ms": k8["int_mm_ms"],
        "int_mm": ("torch._int_mm at each GEMM's (M, N, K) on an A already "
                   "im2col'd: the GEMM alone, not the same function; "
                   f"{k8['int_mm_null_launches']} launches refused by its "
                   "shape rules are not in the sum"),
        "per": (f"one int8 forward: B={IB}, T={IT}, {HW}x{HW}, base_ch "
                f"{BASE}, the quantizing entry on a bf16 x with static "
                f"scales, bf16 out ({k8['shapes']} shapes, "
                f"{k8['launches_per_pass']} launches; ms_dynamic with "
                "dynamic scales, ms_int8_input on an int8 x)"),
        "resnet": {"per": f"one int8 request: B={B}, T={T}, {HW}x{HW}",
                   **{k: k8_resnet[k] for k in (
                       "ms", "ms_dynamic", "ms_int8_input", "plain_ms",
                       "cudnn_bf16_ms", "int_mm_ms", "int_mm_null_launches",
                       "bound_ms", "launches_per_pass", "routes")}}})
    for k in kernels:
        k["surface_launches"] = surface_counts.get(k["name"], 0)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
