#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

1. setup   — the card's name and power limit; TF32 off for matmul and cuDNN;
             cuDNN deterministic (the stem conv's backward), so two kernel
             paths with the same sums give the same gradient bits.
2. build   — nvcc builds the kernels from ``src/repro_torch/csrc`` (one
             process per source, all started together); prints the build
             seconds and each kernel's registers, shared memory and spills,
             and from the SASS the highest register and local memory
             operations of each K9 wgmma and fused PE instance.
3. parity  — each kernel's launcher against its plain PyTorch version on
             the card, on seeded spike maps at densities {0, 0.1, 0.5} with
             silent row blocks, at the main paths' shapes plus ragged ones:
             the int8 (``fused_dense``) operands, then the packed ones of
             ``fused_packed`` (pack and unpack bit-equal, round trip exact;
             the pack on the stem's map, on [4, M, N] trains at N 64, 128,
             256 and 512 and on ragged maps, each also 16-byte misaligned
             and into outputs filled with a sentinel, every entry written;
             the unpack of the same words in int8, bf16 and f32 at the
             logical extent, into 16-byte aligned and misaligned outputs
             inside buffers filled with a sentinel: every element written,
             none past the extent; the packed fused PE and spike-matmul
             variants, each packed fused PE launch bit-equal to the int8
             one; every spike-x
             fused PE launch also launched again, bit-equal), then the fused
             PE's LIF state (T > 1) at every int8 pass shape: v_prev ~
             randn, s_prev ~ Bernoulli(0.5), hard and soft reset, tau 0.5
             and 0.7, int8 and packed x / spike residual / q / out, with and
             without the emitted current, each packed launch bit-equal to
             the int8 launch; then the
             KD training's: the dx kernel with and without the membrane
             current for all four surrogates, the dw kernel on int8 and on
             packed x (bit-equal on a second launch and to the int8 launch,
             silent tiles contributing exactly 0), the QK
             mask kernel (bit-equal) and the fused PE's emitted current
             (its spikes exactly its own current thresholded); then the
             gated and two-level routes of the spike matmul (int8 and
             packed x), the fused PE (int8 in/out with residual, q and
             emitted current; packed in/out with packed residual and q;
             both also with the LIF state) and dw (int8 and packed x), at
             silent-block fractions {0, 0.5, 0.9, 1.0} with a
             fully silent row block and clustered silent stripes, on 128-
             and 256-wide blocks: each against its plain version and bit
             for bit against the dense skip on the same operands; then
             the LM's head-blocked, dense-activation fused PE pass and K3
             on its wo at the decode route (16 and 64 rows), each against
             its plain version and bit for bit against the tile route
             (K2's float-x tile, K3's 128-row tile).
             Every K3 and K4 launch, here and on each main path's own
             operands in the timing phase, is also held bit for bit to the
             ascending f32 chain (``spike_matmul_chain_ref``: one sum from
             +0 over the k its route keeps) and launched again into an
             output filled with NaN, which must come back with none.
   constants — the cost model's constants measured on the card (the values
             ``launch/roofline.py`` carries): the f32 FMA rate of the
             dense-skip spike matmul, a 1 GiB copy's rate, one launch,
             ``compact_kmap``, and a stripe-skipped step's efficiency.
4. end to end — QKFResNet-11 at full width (64/128/256/512 channels,
             QKFormer d=512, CIFAR-10 32x32x3 inputs), random weights from
             ``torch.Generator`` seed 0 with every BN beta = 0.5, folded by
             ``fuse_model``; 256 seeded images through ``forward`` under
             ``"fused_dense"`` and ``"fused_packed"`` (the kernels) and
             ``"reference"`` (plain PyTorch) on the card. Launch counts are
             reset just before each kernel path's forward and read just
             after it. Then VGG-11 at full width, batch 64, under
             ``"fused_packed"`` against ``"reference"`` (parity only: it is
             the arch that reaches the packed max-pool). Then the auto
             policies: the same net under ``"auto"`` and ``"auto_packed"``
             at this busy regime and at a quiet one (each resblock's first
             BN beta lowered until an operand is at most half active), per
             layer the tuner's plan, the measured sparsity and the
             launches, held to the same gates against ``"reference"`` and
             bit-equal to the fixed fused policy where every plan is fused;
             and the plan the card's cost model gives each layer at every
             sparsity bucket.
5. training — the paper's KD step (``train.trainer.make_kd_train_step``):
             the same QKFResNet-11 unfused, the ANN ResNet-18 teacher at
             full width in eval mode, SGD momentum 0.9, weight decay 5e-4,
             ``cosine_lr(0.1, 10)``, ``KDConfig(alpha=0.7)``, batches of
             ``SyntheticImageDataset(seed=0)``. Three steps from one initial
             state under ``reference+grad``, ``fused_dense+grad`` and
             ``fused_packed+grad`` on the BN-folded graph, and under
             ``reference+grad`` and ``fused_dense+grad`` on the unfused one;
             each step's launch counts are reset before it and read after
             it. The packed path's losses and gradients must be bit-equal to
             the dense path's. The first step of each kernel path is held
             (spike totals 0.1 %, loss 1e-4, gradients a relative L2 error
             of 1e-3 per leaf) on the folded graph against
             ``reference+grad``, and on the unfused graph against the same
             ``fused_dense+grad`` step with every kernel launcher swapped
             for its plain version on the card: there train-mode BN carries
             a one-ulp change of any conv current to every later layer, so
             ``reference+grad``, whose cuDNN convs sum in another order,
             is printed beside it for information only. Then three folded
             steps at the quiet regime under ``auto+grad`` (the tuner fed
             by ``observe_train_sparsity``) against ``fused_dense+grad``:
             equal spike totals and the same gates. Then the three gated
             kernels launched through the ops entry points with an
             explicit ``skip=`` on operands the model's layers produced,
             bit-equal to the dense skip: their rows report the first auto
             path that launched them, else these launches.
5b. T      — the paper's T = 4 baseline: the same QKFResNet-11 at
             ``timesteps=4`` (each fused PE pass a stateful launch a step).
             Forward under ``fused_dense`` and ``fused_packed`` (launch
             counts reset just before and read just after each: fused PE
             52, spike matmul 12, LIF 4, head 4; packed also 14 packs and 5
             unpacks) against ``reference`` (spike totals 0.1 %, top-1 >=
             99 %, packed equal to dense), median forwards at T = 4 beside
             T = 1, the profiler's breakdown of a fused_dense and a
             fused_packed forward; three
             folded KD steps per path under ``reference+grad``,
             ``fused_dense+grad`` and ``fused_packed+grad`` (launches
             asserted: dx and dw 64 a step), step 1 held to the training
             gates, packed bit-equal to dense, the median step, its split
             and peak memory, and a profiled fused_dense+grad step. Then
             the dw launches of the folded ``fused_packed+grad`` step (T =
             1) replayed on their spikes packed (packed_in), dense and
             gated, bit-equal to the int8 launches.
6. timing  — CUDA events: median forward time of each policy at both
             regimes, the host time the tuner's metadata reads add to an
             auto forward, the profiler's device breakdown of both kernel
             paths, the launch floor (an empty kernel's launch, timed as
             the rows are; a row whose bound lies under its launches times
             it says so), and each kernel's device time at the operands
             its path gave it (``device_time``: each call bracketed by
             events after a 256 MB write evicts the L2, all queued behind
             long matmuls,
             so a wrapper's host work does not show), beside its bound
             (no row may read below it), its plain version, its
             dense-skip twin (a gated route) and, where one PyTorch call
             does the same product, that call (the unfused KD step's 16
             spike matmul launches are the row ``spike_matmul_unfused``;
             each K3 and K4 launch line names the tile its planner chose);
             the worst share of the RTOL/ATOL gate that a spike-x fused PE
             launch's current and membrane potential use on each path's
             own operands, and the largest gap beside the kernel's
             near-threshold recheck band (``[gate share]``); for the LM
             rows also the route they took, the tile route's time on the same
             operands and the host clock, and the LM step's K2 launches per
             projection beside ``torch.matmul``; the median step time of each
             training path with its forward/backward split and peak
             memory, and the profiler's top kernels of one
             ``fused_dense+grad`` step.
7. serve   — (run before the timing phase, whose kernel rows it feeds)
             the spiking QKFormer LM at qwen3-1.7b's published width
             (28 layers, d_model 2048, 16 heads over 8 KV heads of 128,
             d_ff 6144, vocab 151936; bf16 activations, f32 parameters
             from a CUDA ``torch.Generator`` seed 0) through the
             continuous-batching engine (16 slots, 64-token prefill
             chunks) on a 32-request greedy trace from
             ``numpy.random.default_rng(0)`` under ``"fused_dense"``,
             ``"fused_packed"`` and ``"reference"``: the launches of one
             decode tick and one prefill chunk (``fused_pe`` 56,
             ``spike_matmul`` 28, counts reset just before and read just
             after), every fused PE and spike matmul launch of that tick
             and chunk replayed on the decode route and on the 128-row
             tile, equal bit for bit (the count printed), the engine's
             tokens against a direct
             ``prefill_chunk`` / ``decode_step`` loop, ``fused_packed``
             tokens and per-layer spike totals against ``fused_dense``'s,
             the fused path against ``"reference"`` on a 4-layer f32
             variant (spike totals 0.1 %, top-1 >= 99 %; at bf16 the two
             compute different functions, so that agreement is printed
             only), each policy's tick, chunk, TTFT, wall time and memory,
             and a profiled decode tick. The parity phase also holds the
             LM's head-blocked, dense-activation fused PE pass against its
             plain version at K = 2048.
8. softmax — qwen3-1.7b as published (softmax attention, GQA, qk_norm,
             RoPE, a KV cache) through the engine against a direct loop,
             chunked against blocking prefill, an f8 KV pool; K9 through
             ``ops.attention`` on layer 0's prefill q, k, v (bf16: the
             wgmma route; the 4-layer f32 variant's: the scalar route), the
             route of each launch checked, and each launch again on every
             route it can take against the plain version; the K9 sweep (H /
             Hkv 16/8, 16/16, 16/1, D 128/64/32, S 64/300/2048, causal and
             full, f32 and bf16, bf16 on both routes; D 96/112/48 (bf16 on
             the wgmma route at a padded instance, and on the scalar route)
             and 37 (the scalar route's general instance), f32 and bf16;
             q scaled by 8, f32 and bf16, each route and the plain version
             against an f64 result); K9 at S 248 / 512 / 2048 / 8192 by
             device time on every route beside its plain version, SDPA, its
             bound (none below it), the f32 targets and the one-pass floor,
             and bf16 at D 96 and 112 at S 2048 on both routes beside SDPA
             and the bound.
9. lm train — the spiking QKFormer LM trained at qwen3-1.7b's published
             width and depth (the serve phase's model, random weights from
             a CUDA ``torch.Generator`` seed 0, kept in host memory between
             runs; the earlier phases' captured launches wait in host
             memory meanwhile): 3 steps of ``train.make_train_step``
             (AdamW, clip 1.0, ``linear_warmup_cosine(3e-4, 10, 3)``) on 8
             x 129-token batches of ``SyntheticTokenDataset(seed=0)`` under
             ``"fused_dense+grad"``, ``"fused_packed+grad"`` and
             ``"reference+grad"``: each step's launches (``fused_pe`` 56,
             ``spike_matmul`` 28, dx 28, dw 28, packed also
             ``unpack_spikes`` 56; none for the reference), finite losses
             and gradient norms, packed equal to dense bit for bit (losses,
             gradient norms, spike totals, and the state each step returns:
             every AdamW first-moment leaf of every step, every parameter
             leaf after the last); per policy its step time (median of
             steps 2-3), forward / backward split and peak memory, and a
             profiled ``fused_dense+grad`` step (device busy, idle share).
             The 4-layer f32 variant's first gradient: each fused policy
             against ``reference+grad`` (loss 1e-4, spike totals 0.1 %;
             the gradients' distance printed) and ``fused_dense+grad``
             against the same step on the kernels' plain twins with their
             own sums (``kernels/chain.py``'s ``chain_launchers``: loss and
             spike totals bit for bit, each gradient leaf 1e-3 relative
             L2). One sequence-KD step
             (``examples/torch_spiking_qkformer_lm.py``'s loss,
             ``KDConfig(alpha=0.5, temperature=2.0)``) of the
             ``fused_dense+grad`` student from a frozen softmax qwen3-1.7b
             teacher. The parity phase holds K2 as this step launches it
             (dense f32 / bf16 x of 1024 rows, ``heads``, the emitted
             current, the grouped wk) against its plain version, and its
             current bit for bit against the fused multiply-add chain over
             k ascending (``fma_chain``), the kernel's own order. Its first
             step's launches feed the timing phase's rows ``*_lm_train``.
10. families — (run while the earlier launches wait in host memory) the
             other LM families at their published widths and depths on
             random weights from a CUDA ``torch.Generator`` seed 0, through
             ``build_model`` and ``init``, each freed before the next, on
             8-request greedy traces from ``numpy.random.default_rng(0)``
             (16 new tokens each) through the serve phase's engine (16
             slots, 512 rows, 64-token chunks), every engine run gated
             equal to a direct loop at the engine's shapes (its buckets,
             chunks, slot pool and per-slot lengths): olmoe-1b-7b spiking
             ``qk_spiking`` under ``fused_dense``, ``fused_packed`` and
             ``reference`` (K2 twice and K3 once a layer a tick and a
             chunk, packed tokens equal dense's; a decode tick's launches
             feed the rows ``*_olmoe``) and as published (softmax, the
             MoE FFN); mamba2-130m and zamba2-7b chunked (on ssm_chunk
             128) and blocking; phi-3-vision-4.2b spiking ``qk_spiking``:
             a prefill of 4 x 1024 seeded patch embeddings (merged to 256
             by spike counts) and 64 text tokens, 16 ``decode_step``s,
             then the engine on the text trace (rows ``*_phi3``);
             seamless-m4t-large-v2: a prefill of 4 x 256 seeded frames
             (pooled to 128) and a 16-token target, 32 ``decode_step``s.
             A ``[families]`` line a config: parameters, peak memory,
             prefill, the decode tick's p50 / p99, tokens/s, a bare
             tick's device busy and idle share. The f32 variants (full
             width, 4 layers; zamba2 9, one group under its shared
             attention site): spiking olmoe and phi-3 teacher-forced under
             the three policies (spike totals 0.1 %, top-1 99 %); mamba2,
             zamba2 and seamless (4 + 4 layers) decode equal to a longer
             prefill's continuation (2e-3), mamba2 and zamba2 chunked
             prefill equal to blocking (1e-4, greedy tokens exactly; at
             bf16 the tokens are compared for information).
11. driver — (run while the earlier launches wait in host memory) the
             training entry point as a user launches it,
             ``repro_torch.launch.train.main`` with ``--arch qwen3-1.7b
             --spiking --qk-attention --policy fused_dense --batch 8 --seq
             128`` at full width and depth, on ``torch.distributed`` (NCCL,
             a world of one): 4 steps with ``--ckpt-every 2
             --simulate-failure 3`` (a checkpoint of the 20.6 GB state
             under ``build/``, the failure, the restore and remesh), then
             4 steps uninterrupted; counts set to 0 before each run and
             read after it (per step ``fused_pe`` 56, ``spike_matmul`` 28,
             dx 28, dw 28). Gates: the reference's events; step 0's loss
             bit-equal to phase 9's first ``fused_dense+grad`` loss; the
             four losses and every leaf of the final parameters and AdamW
             moments bit-equal between the two runs. Then ``--compress``
             for 3 steps: step 0's loss bit-equal to the uncompressed
             one's, every loss finite, step 2's within 0.5 of the
             uncompressed run's; and one compressed step's residual of the
             embedding equal to g - decompress(compress(g)) of the first
             step's gradient. Prints the checkpoint's bytes, save and
             restore seconds and GB/s, the disk's free space, the driver's
             steps beside phase 9's, and an A/B of ``make_train_step``
             with and without the all-reduce; no process group is left.
12. kd pipeline — (run while the earlier launches wait in host memory)
             the paper's experiment as ``examples/torch_train_kd_cifar.py``
             runs it: ``run("vgg11", 220, policy="fused_dense", width=1.0)``,
             the ResNet-18 teacher and the VGG-11 student at full width,
             batch 64, KDT, F&Q (4-bit), KD-QAT and the W2TTFS head; counts
             set to 0 before the run and read after it. Gates: KDT's first
             step against the same step with every launcher swapped for
             its plain version (``plain_launchers``: spike totals 1e-3,
             loss 1e-4, gradients a relative L2 error of 1e-3 per leaf;
             ``reference+grad`` printed for information), one KDT step's
             launches from the layer list, the W2TTFS head's logits
             against the AP head's on the KD-QAT weights over the 512
             evaluation images (top-1 agreement >= 99 %), every stage's
             accuracy finite, and the deployment artifact's spikes per
             image equal under ``fused_dense`` and ``fused_packed``.
             Prints the five accuracies, the claim lines, each stage's
             seconds, the step medians, the peak memory and the
             profiler's breakdown of a KDT step.
13. contracts — the contract sweep (``repro_torch.analysis.contracts``)
             on fake CPU tensors, then every fused registry point of its
             corpus on CUDA tensors: each output's shapes, dtypes,
             formats and ``vld_cnt`` grids equal to the sweep's.
14. dryrun — (run while the earlier launches wait in host memory) phase
             11's cell, qwen3-1.7b spiking ``qk_spiking`` at full width,
             8 x 129 tokens, traced by ``launch.dryrun.run_cell`` on fake
             CPU tensors at a (1, 1) mesh under ``reference+grad`` and
             ``fused_dense+grad``, then the same ``make_train_step`` step
             run once, untimed, on the card (NCCL, a world of one) under
             ``launch.hlo_analysis.OpRecorder``; counts set to 0 before
             the step and read after it (the LM step's launches under
             ``fused_dense+grad``, none under the reference). Gates: the
             spec half's argument bytes equal the parameters', AdamW
             state's and batch's on the card exactly; under
             ``reference+grad`` the card's record has the trace's ops,
             flops and bytes exactly; the all-reduces, in the trace and on
             the card, number the gradient leaves plus the metrics' one;
             the predicted peak (arguments + temp) within 10 % of
             ``torch.cuda.max_memory_allocated()`` over the step (after
             ``reset_peak_memory_stats``). Printed: the same under
             ``fused_dense+grad`` (fused ops one node each), the useful
             ratio 6 N D / traced flops, the spec half of every registry
             cell at the ``single`` and ``multi`` meshes, and the roofline
             report's markdown priced as one H100 SXM.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the f32 rate outside the
# tensor cores (IEEE f32 is what parity with the reference needs) and the
# bf16 tensor-core rate (f32 accumulation), at which a bf16 K9 call's work
# is priced (``flash_ops_ms``): QK^T of the bf16 q and k once, and PV, whose
# f32 weights p split exactly into three bf16 terms, three times; and dw's
# (``ops_ms``): x^T g with g split the same way, three times
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_TC_OPS_PER_S = 989e12
BATCH = 256              # images in the end-to-end forward
ITERS = 10               # timed forwards per policy
V_TH = 1.0
NEAR_VTH = 1e-4          # |plain current - v_th| below this may flip
RTOL, ATOL = 1e-5, 1e-4  # f32 outputs: the sums run in another order
DW_C = 3.0               # dw limit, in sqrt(n) u |x|ᵀ|g| (check_dw)
VGG_BATCH = 64           # images in the VGG-11 packed parity forward
TRAIN_BATCH = 256        # images in a training step
TRAIN_STEPS = 3          # steps of each training path from one state
TRAIN_ITERS = 5          # timed steps per training path
# the KD training kernels, which an inference forward never launches
NO_BACKWARD = {"spike_matmul_dx": 0, "spike_matmul_dw": 0, "qk_attention": 0}
# the softmax attention kernel, which only ops.attention launches
NO_ATTENTION = {"flash_attention": 0}
# the gated routes, which only the auto policies (or an explicit skip) launch
NO_GATED = {"fused_pe_gated": 0, "spike_matmul_gated": 0,
            "spike_matmul_dw_gated": 0}
# launches per forward of each kernel path, every count read after a reset
EXPECTED_LAUNCHES = {
    "fused_dense": {"lif_update": 1, "fused_pe": 13, "spike_matmul": 3,
                    "w2ttfs_pool": 1, "pack_spikes": 0, "unpack_spikes": 0,
                    **NO_BACKWARD, **NO_GATED, **NO_ATTENTION},
    "fused_packed": {"lif_update": 1, "fused_pe": 13, "spike_matmul": 3,
                     "w2ttfs_pool": 1, "pack_spikes": 1, "unpack_spikes": 1,
                     **NO_BACKWARD, **NO_GATED, **NO_ATTENTION},
}
# launches per step of the BN-folded training graph under the kernels
FOLD_STEP_LAUNCHES = {"lif_update": 1, "fused_pe": 13, "spike_matmul": 3,
                      "w2ttfs_pool": 1, "pack_spikes": 0, "unpack_spikes": 0,
                      "spike_matmul_dx": 16, "spike_matmul_dw": 16,
                      "qk_attention": 0, **NO_GATED, **NO_ATTENTION}
# the multi-timestep baseline (the T phase): the paper's T = 4 comparison.
# A forward runs every fused PE pass, shortcut matmul, the stem's LIF and
# the head once a step; under fused_packed the stem packs once, each of the
# 13 stateful passes packs its steps in one launch after its scan, and the
# K pass's q is unpacked once a step and the head's map once. A folded
# training step adds one dx and one dw a fused PE pass and shortcut a step.
T_STEPS = 4
EXPECTED_LAUNCHES_T = {
    "fused_dense": {"lif_update": 4, "fused_pe": 52, "spike_matmul": 12,
                    "w2ttfs_pool": 4, "pack_spikes": 0, "unpack_spikes": 0,
                    **NO_BACKWARD, **NO_GATED, **NO_ATTENTION},
    "fused_packed": {"lif_update": 4, "fused_pe": 52, "spike_matmul": 12,
                     "w2ttfs_pool": 4, "pack_spikes": 1 + 13,
                     "unpack_spikes": 4 + 1,
                     **NO_BACKWARD, **NO_GATED, **NO_ATTENTION},
}
FOLD_STEP_LAUNCHES_T = {"lif_update": 4, "fused_pe": 52, "spike_matmul": 12,
                        "w2ttfs_pool": 4, "pack_spikes": 0,
                        "unpack_spikes": 0, "spike_matmul_dx": 64,
                        "spike_matmul_dw": 64, "qk_attention": 0,
                        **NO_GATED, **NO_ATTENTION}
T_FORWARD = {policy: f"forward {policy} T={T_STEPS}"
             for policy in ("fused_dense", "fused_packed")}
# the explicit packed-x dw launches (on the packed training step's operands)
PACKED_DW_PATH = "explicit packed dw"
# the folded fused_packed+grad step: its 13 unpacks (to f32) at T = 1, 52
# at T = 4
PACKED_STEP = "train fold fused_packed+grad"
PACKED_STEP_T = f"{PACKED_STEP} T={T_STEPS}"
# row of the kernels line -> (kernel, path whose launches it reports,
# source, the TPU kernel's pallas_call it replaces)
ROWS = {
    "lif_update": ("lif_update", "fused_dense",
                   "src/repro_torch/csrc/lif_update.cu",
                   "src/repro/kernels/lif_update/lif_update.py:62"),
    "fused_pe": ("fused_pe", "fused_dense",
                 "src/repro_torch/csrc/fused_pe.cuh",
                 "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul": ("spike_matmul", "fused_dense",
                     "src/repro_torch/csrc/spike_matmul.cu",
                     "src/repro/kernels/spike_matmul/spike_matmul.py:83"),
    "w2ttfs_pool": ("w2ttfs_pool", "fused_dense",
                    "src/repro_torch/csrc/w2ttfs_pool.cu",
                    "src/repro/kernels/w2ttfs_pool/w2ttfs_pool.py:49"),
    "pack_spikes": ("pack_spikes", "fused_packed",
                    "src/repro_torch/csrc/pack_spikes.cu",
                    "src/repro/kernels/packed/packed.py:66"),
    "unpack_spikes": ("unpack_spikes", "fused_packed",
                      "src/repro_torch/csrc/unpack_spikes.cu",
                      "src/repro/kernels/packed/packed.py:96"),
    "fused_pe_packed": ("fused_pe", "fused_packed",
                        "src/repro_torch/csrc/fused_pe.cuh",
                        "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul_packed": ("spike_matmul", "fused_packed",
                            "src/repro_torch/csrc/spike_matmul.cu",
                            "src/repro/kernels/spike_matmul/"
                            "spike_matmul.py:83"),
    "fused_pe_emit": ("fused_pe", "train fold fused_dense+grad",
                      "src/repro_torch/csrc/fused_pe.cuh",
                      "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul_dx": ("spike_matmul_dx", "train fold fused_dense+grad",
                        "src/repro_torch/csrc/spike_matmul_dx.cu",
                        "src/repro/kernels/spike_matmul/backward.py:106"),
    "spike_matmul_dw": ("spike_matmul_dw", "train fold fused_dense+grad",
                        "src/repro_torch/csrc/spike_matmul_dw.cu",
                        "src/repro/kernels/spike_matmul/backward.py:162"),
    "qk_attention": ("qk_attention", "train unfused fused_dense+grad",
                     "src/repro_torch/csrc/qk_attention.cu",
                     "src/repro/kernels/qk_attention/qk_attention.py:52"),
    # every conv after the stem and every QKFormer linear of the unfused
    # step: 16 launches, up to 4096 x 4608 x 512
    "spike_matmul_unfused": ("spike_matmul", "train unfused fused_dense+grad",
                             "src/repro_torch/csrc/spike_matmul.cu",
                             "src/repro/kernels/spike_matmul/"
                             "spike_matmul.py:83"),
    # the gated routes: their path is the first of GATED_PATHS that
    # launched them (resolved at run time)
    "fused_pe_gated": ("fused_pe_gated", None,
                       "src/repro_torch/csrc/fused_pe.cuh",
                       "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul_gated": ("spike_matmul_gated", None,
                           "src/repro_torch/csrc/spike_matmul.cu",
                           "src/repro/kernels/spike_matmul/"
                           "spike_matmul.py:171"),
    "spike_matmul_dw_gated": ("spike_matmul_dw_gated", None,
                              "src/repro_torch/csrc/spike_matmul_dw.cu",
                              "src/repro/kernels/spike_matmul/"
                              "backward.py:249"),
}
# the spiking LM's serving path (phase 7): one decode tick at 16 slots and
# one 64-token prefill chunk of qwen3-1.7b, 2 fused PE passes (wq; wk with
# the head-blocked mask) and one spike matmul (wo) a layer
ROWS.update({
    "fused_pe_heads": ("fused_pe", "serve fused_dense decode",
                       "src/repro_torch/csrc/fused_pe.cuh",
                       "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "fused_pe_heads_prefill": ("fused_pe", "serve fused_dense prefill chunk",
                               "src/repro_torch/csrc/fused_pe.cuh",
                               "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "fused_pe_heads_packed": ("fused_pe", "serve fused_packed decode",
                              "src/repro_torch/csrc/fused_pe.cuh",
                              "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul_lm": ("spike_matmul", "serve fused_dense decode",
                        "src/repro_torch/csrc/spike_matmul.cu",
                        "src/repro/kernels/spike_matmul/spike_matmul.py:83"),
    "spike_matmul_lm_packed": ("spike_matmul", "serve fused_packed decode",
                               "src/repro_torch/csrc/spike_matmul.cu",
                               "src/repro/kernels/spike_matmul/"
                               "spike_matmul.py:83"),
})
# the LM rows' time on the 128-row tile before the decode route took their
# launches, as recorded in PERF.md section 6 (host clock around
# back-to-back launches, one NVIDIA H100 80GB HBM3 at 700 W): printed
# beside this run's tile-route time, which the kernels line reports
# (``tile_route_ms``)
TILE_MS_BEFORE = {"fused_pe_heads": 13.0847,
                  "fused_pe_heads_prefill": 13.0866,
                  "fused_pe_heads_packed": 13.0837, "spike_matmul_lm": 6.2504,
                  "spike_matmul_lm_packed": 6.1213}
# the softmax LM's K9: one ops.attention launch on layer 0's q, k and v of
# a full-width prefill of the trace's longest prompt (phase 8): bf16, the
# wgmma route; and the same on the 4-layer f32 variant, the scalar route
K9_PATH = "ops.attention at qwen3-1.7b prefill"
K9_F32_PATH = "ops.attention at qwen3-1.7b prefill, f32 variant"
# K9's route -> the row of the kernels line its launches and errors go to
K9_ROW = {"wgmma": "flash_attention", "scalar": "flash_attention_scalar"}
ROWS.update({
    "flash_attention": ("flash_attention", K9_PATH,
                        "src/repro_torch/csrc/flash_attention_wgmma.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:80"),
    "flash_attention_scalar": ("flash_attention", K9_F32_PATH,
                               "src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention/"
                               "flash_attention.py:80"),
})
# the T = 4 baseline: the fused PE's LIF state (with_state) on the forward
# paths and the folded training step, the pack and the head on the forward
# paths, and the dw kernel's packed x (packed_in), launched on the packed
# training step's dw operands
ROWS.update({
    "fused_pe_state": ("fused_pe", T_FORWARD["fused_dense"],
                       "src/repro_torch/csrc/fused_pe_state.cu",
                       "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "fused_pe_state_packed": ("fused_pe", T_FORWARD["fused_packed"],
                              "src/repro_torch/csrc/"
                              "fused_pe_state_packed.cu",
                              "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "fused_pe_state_emit": ("fused_pe",
                            f"train fold fused_dense+grad T={T_STEPS}",
                            "src/repro_torch/csrc/fused_pe_state.cu",
                            "src/repro/kernels/fused_pe/fused_pe.py:362"),
    # the stem's pack and each stateful pass's pack of its four steps (14
    # launches), and the head once a step (4)
    "pack_spikes_state": ("pack_spikes", T_FORWARD["fused_packed"],
                          "src/repro_torch/csrc/pack_spikes.cu",
                          "src/repro/kernels/packed/packed.py:66"),
    "w2ttfs_pool_state": ("w2ttfs_pool", T_FORWARD["fused_dense"],
                          "src/repro_torch/csrc/w2ttfs_pool.cu",
                          "src/repro/kernels/w2ttfs_pool/w2ttfs_pool.py:49"),
    # the unpacks of the T = 4 forward (the K pass's q once a step, the
    # head's map once) and of the packed KD step (each fused PE pass's
    # spikes, to f32), at T = 1 and T = 4
    "unpack_spikes_state": ("unpack_spikes", T_FORWARD["fused_packed"],
                            "src/repro_torch/csrc/unpack_spikes.cu",
                            "src/repro/kernels/packed/packed.py:96"),
    "unpack_spikes_step": ("unpack_spikes", PACKED_STEP,
                           "src/repro_torch/csrc/unpack_spikes.cu",
                           "src/repro/kernels/packed/packed.py:96"),
    "unpack_spikes_step_t4": ("unpack_spikes", PACKED_STEP_T,
                              "src/repro_torch/csrc/unpack_spikes.cu",
                              "src/repro/kernels/packed/packed.py:96"),
    "spike_matmul_dw_packed": ("spike_matmul_dw", PACKED_DW_PATH,
                               "src/repro_torch/csrc/spike_matmul_dw.cu",
                               "src/repro/kernels/spike_matmul/"
                               "backward.py:162"),
    "spike_matmul_dw_gated_packed": ("spike_matmul_dw_gated", PACKED_DW_PATH,
                                     "src/repro_torch/csrc/"
                                     "spike_matmul_dw.cu",
                                     "src/repro/kernels/spike_matmul/"
                                     "backward.py:249"),
})
# the spiking LM's training step (phase 9): per layer two fused PE passes
# with the emitted current (wq; wk with the head-blocked mask), K3 on wo and
# its dx and dw, and under fused_packed+grad two unpacks to f32
LM_TRAIN_PATH = "train lm {}"
ROWS.update({
    "fused_pe_lm_train": ("fused_pe", LM_TRAIN_PATH.format("fused_dense+grad"),
                          "src/repro_torch/csrc/fused_pe.cuh",
                          "src/repro/kernels/fused_pe/fused_pe.py:362"),
    "spike_matmul_lm_train": ("spike_matmul",
                              LM_TRAIN_PATH.format("fused_dense+grad"),
                              "src/repro_torch/csrc/spike_matmul.cu",
                              "src/repro/kernels/spike_matmul/"
                              "spike_matmul.py:83"),
    "unpack_spikes_lm_train": ("unpack_spikes",
                               LM_TRAIN_PATH.format("fused_packed+grad"),
                               "src/repro_torch/csrc/unpack_spikes.cu",
                               "src/repro/kernels/packed/packed.py:96"),
    "spike_matmul_dx_lm_train": ("spike_matmul_dx",
                                 LM_TRAIN_PATH.format("fused_dense+grad"),
                                 "src/repro_torch/csrc/spike_matmul_dx.cu",
                                 "src/repro/kernels/spike_matmul/"
                                 "backward.py:106"),
    "spike_matmul_dw_lm_train": ("spike_matmul_dw",
                                 LM_TRAIN_PATH.format("fused_dense+grad"),
                                 "src/repro_torch/csrc/spike_matmul_dw.cu",
                                 "src/repro/kernels/spike_matmul/"
                                 "backward.py:162"),
})
# the other LM families (phase 10): one decode tick at 16 slots of the
# spiking QKFormer olmoe-1b-7b (16 heads of 128 over d_model 2048) and
# phi-3-vision-4.2b (32 heads of 96 over 3072) under fused_dense, two fused
# PE passes and one spike matmul a layer
FAMILY_PATH = "families {} fused_dense decode"
FAMILY_ROWS = {"olmoe": "olmoe-1b-7b", "phi3": "phi-3-vision-4.2b"}
for _tag, _arch in FAMILY_ROWS.items():
    ROWS[f"fused_pe_heads_{_tag}"] = (
        "fused_pe", FAMILY_PATH.format(_arch),
        "src/repro_torch/csrc/fused_pe.cuh",
        "src/repro/kernels/fused_pe/fused_pe.py:362")
    ROWS[f"spike_matmul_lm_{_tag}"] = (
        "spike_matmul", FAMILY_PATH.format(_arch),
        "src/repro_torch/csrc/spike_matmul.cu",
        "src/repro/kernels/spike_matmul/spike_matmul.py:83")
# where a gated kernel's row reads its launches, in order of preference:
# the auto paths, then the explicit-skip launches on the model's operands
GATED_PATHS = ("auto_packed quiet", "auto quiet", "auto_packed busy",
               "auto busy", "train fold auto+grad quiet", "explicit skip")


def say(*parts) -> None:
    print(*parts, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 1
def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_setup(torch) -> str:
    smi = gpu_name_and_power()
    say(f"[setup] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    say(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    say(f"[setup] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    say(f"[setup] torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}; deterministic = "
        f"{torch.backends.cudnn.deterministic}")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_build(build_mod) -> None:
    t0 = time.perf_counter()
    info = build_mod.build()
    build_mod.library()
    say(f"[build] {info.path.name}: nvcc {info.seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s in all)")
    for line in info.ptxas_log.splitlines():
        if ("Compiling entry" in line or "Used" in line or "spill" in line
                or "wgmma" in line or line.startswith("==")):
            say(f"[build]   {line.strip()}")
    sass_registers(build_mod, info.path, ("flash_wgmma_kernel",
                                          "fused_pe_kernel",
                                          "fused_pe_float_kernel",
                                          "spike_matmul_tile_kernel"))


def sass_registers(build_mod, lib, kernels: tuple) -> None:
    """For each instance of each of ``kernels`` in the built library (named
    by its mangled template arguments: for ``fused_pe_kernel`` ILi<x kind:
    0 int8, 1 packed, 2 f32, 3 bf16>ELb<emit_current>ELi<skip>ELb<
    with_state>), from its SASS (``cuobjdump -sass``, run once): the highest
    register it names and its local memory (spill) loads and stores, apart
    before the first setmaxnreg, from there to the second (a
    warp-specialised kernel's first branch), and after it. Information
    only: ptxas's "Used N registers" is the launch's count, not what a
    branch raised by setmaxnreg may use."""
    tool = Path(build_mod._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    reg, local = re.compile(r"\bR(\d+)\b"), re.compile(r"\b(?:LDL|STL)\b")
    for fn in text.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        kernel = next((k for k in kernels if k in name), None)
        if kernel is None:
            continue
        spans = [(max(map(int, reg.findall(span)), default=0),
                  len(local.findall(span)))
                 for span in fn.split("USETMAXREG")]
        say(f"[build]   sass {name[name.find(kernel):][:48]}: per setmaxnreg "
            f"span, highest register / local loads and stores: "
            + ", ".join(f"R{r} / {n}" for r, n in spans))


# ------------------------------------------------------------------ phase 3
# the operands the parity phase makes, as against a main path's own
PARITY_OPERANDS = "parity operands"
# the port's hand-written kernels, as the profiler names them
HAND_WRITTEN = ("fused_pe_kernel", "fused_pe_float_kernel",
                "fused_pe_decode_kernel", "spike_matmul_tile_kernel",
                "spike_matmul_decode_kernel", "spike_matmul_dx_kernel",
                "spike_matmul_dw_kernel", "dw_sum_kernel",
                "pack_spikes_kernel", "unpack_spikes_kernel",
                "lif_update_kernel", "w2ttfs_pool_kernel",
                "qk_attention_kernel", "flash_attention_kernel",
                "flash_wgmma_kernel")


class Parity:
    """Worst errors per kernel across every comparison made, and the worst
    share of the gate that a spike-x fused PE launch's current and membrane
    potential used, per (path, row): |kernel - plain| / (ATOL + RTOL *
    |plain|), on the phase's operands or a main path's."""

    def __init__(self):
        self.max_abs_err: dict[str, float] = {}
        self.near_vth: dict[str, int] = {}
        self.gate_share: dict[tuple, list] = {}

    def note(self, name: str, err: float, near: int = 0) -> None:
        self.max_abs_err[name] = max(self.max_abs_err.get(name, 0.0), err)
        self.near_vth[name] = self.near_vth.get(name, 0) + near

    def note_share(self, path: str, row: str, current: float,
                   potential: float, gap: float) -> None:
        worst = self.gate_share.setdefault((path, row), [0.0, 0.0, 0.0, 0])
        worst[0] = max(worst[0], current)
        worst[1] = max(worst[1], potential)
        worst[2] = max(worst[2], gap)
        worst[3] += 1

    def print_shares(self, K, parity_operands: bool) -> None:
        """The readings on the parity phase's operands, or on the paths'."""
        for (path, row), (cur, pot, gap, n) in sorted(
                self.gate_share.items()):
            if (path == PARITY_OPERANDS) != parity_operands:
                continue
            say(f"[gate share] {row} on {path}: worst |kernel - plain| / "
                f"(ATOL + RTOL |plain|) over {n} launches: current {cur:.4f},"
                f" membrane potential before the threshold {pot:.4f}; its "
                f"largest gap {gap:.3e} (the kernel's recheck band "
                f"{K.RECHECK_BAND:.3e})")


def rand_spikes(torch, gen, m: int, k: int, density: float, dev):
    """Seeded 0/1 int8 map; every third 128-row block is silent, so the
    kernels' block skip runs at any density."""
    x = (torch.rand((m, k), generator=gen, device=dev) < density)
    rows = torch.arange(m, device=dev)
    x[(rows // 128) % 3 == 1] = False
    return x.to(torch.int8)


def fused_pe_row(args) -> str:
    """The kernels-line row a fused PE launch's operands belong to."""
    xp, packing, gate, heads, state = args[0], args[10], args[12], args[13], \
        args[14]
    if gate is not None:
        return "fused_pe_gated"
    if state is not None:
        return ("fused_pe_state_emit" if packing.current else
                "fused_pe_state_packed" if packing.x else "fused_pe_state")
    if packing.current:
        return ("fused_pe_lm_train" if xp.is_floating_point()
                else "fused_pe_emit")
    return ("fused_pe_heads" if heads is not None or xp.is_floating_point()
            else "fused_pe_packed" if packing.x else "fused_pe")


def check_fused_pe(torch, K, args, parity: Parity, label: str,
                   route: str = "tile", path: str = PARITY_OPERANDS) -> None:
    """Kernel vs plain version on one set of block-aligned operands (dense
    or packed, stateless or with the LIF state; the row is
    ``fused_pe_row``'s), launched on ``route``: spikes equal where the plain membrane potential is
    not within NEAR_VTH of v_th, v_next within RTOL/ATOL there, the
    emitted current within RTOL/ATOL and the spikes exactly that current
    (plus the decayed state, each operation rounded as the kernel rounds
    it) thresholded and masked; with a train's earlier steps, the state
    it decided on (v_prev, but where its recheck replayed them) within
    RTOL/ATOL of v_prev, and its operands unwritten. A spike x's launch
    (the tensor-core tile) is also launched again, bit-equal, and, on a
    main path's operands (``path``), with the current emitted, whose share
    of the gate (and its membrane potential's) ``parity`` records."""
    state = args[14]
    held = None if state is None else (state.v_prev.clone(),
                                       state.s_prev.clone())
    replays = state is not None and state.x_hist is not None
    k_first = K.fused_pe_cuda(*args, route=route, state_out=replays)
    k_out, k_vld, *k_rest = k_first
    args = K.fused_pe_tile_operands(args)
    (xp, wp, vld, bp, rp, qp, m0, n0, v_th, qk, packing, block_n, gate,
     heads, state, ws) = args
    row = fused_pe_row(args)
    if held is not None:
        require(torch.equal(held[0], state.v_prev)
                and torch.equal(held[1], state.s_prev),
                f"{row} {label}: the launch wrote its state operands")
    p_out, p_vld, *p_rest = K.fused_pe_block_ref(*args, state_out=replays)
    k_used = p_used = None
    if replays:
        k_used, p_used = k_rest.pop(), p_rest.pop()
        require(torch.allclose(k_used, p_used, rtol=RTOL, atol=ATOL),
                f"{row} {label}: the state decided on is not v_prev")
    if packing.out:
        k_spk, p_spk = K.unpack_words(k_out), K.unpack_words(p_out)
        inv = K.check_packed_invariants(K.PackedSpikes(k_out, k_vld,
                                                       (m0, n0), 128, block_n))
        require(inv["ok"], f"{row} {label}: packed output {inv}")
    else:
        k_spk, p_spk = k_out, p_out
    cur = (K.spike_matmul_block_ref(xp, wp, vld, packing.x) if gate is None
           else K.spike_matmul_gated_block_ref(xp, wp, gate, packing.x))
    if bp is not None:
        cur = cur + bp.reshape(1, -1)
    if rp is not None:
        cur = cur + (K.unpack_words(rp, torch.float32) if packing.residual
                     else rp)

    def decayed(c, v_prev=None):
        """c plus the decayed state (v_prev, else the launch's), at the
        valid extent [m0, n0]."""
        return state.tau * (state.v_prev if v_prev is None else v_prev) * (
            1.0 - state.s_prev.to(torch.float32)) + c

    v = cur.clone()
    if state is not None:
        v[:m0, :n0] = decayed(cur[:m0, :n0])
    valid = torch.zeros_like(k_spk, dtype=torch.bool)
    valid[:m0, :n0] = True
    near = ((v - v_th).abs() < NEAR_VTH) & valid
    diff = k_spk != p_spk
    bad = int((diff & ~near).sum())
    flips = int((diff & near).sum())
    require(bad == 0, f"{row} {label}: {bad} spikes differ away from v_th")
    require(bool((k_vld == K.block_count_map_2d(k_spk, 128, block_n)).all()),
            f"{row} {label}: vld_next is not the block count of the "
            f"kernel's own spikes")
    require(not bool(k_spk[m0:].any()) and not bool(k_spk[:, n0:].any()),
            f"{row} {label}: padding fired")
    err = float(bad)
    if state is not None:
        k_vn, p_vn = k_rest.pop(0), p_rest.pop(0)
        far = ~near[:m0, :n0]
        err = float(((k_vn - p_vn).abs() * far).max()) if k_vn.numel() \
            else 0.0
        require(torch.allclose(k_vn[far], p_vn[far], rtol=RTOL, atol=ATOL),
                f"{row} {label}: v_next max abs err {err} away from v_th")
    if packing.current:
        (k_c,), (p_c,) = k_rest, p_rest
        cur_err = float((k_c - p_c).abs().max()) if k_c.numel() else 0.0
        err = max(err, cur_err) if state is not None else cur_err
        require(torch.allclose(k_c, p_c, rtol=RTOL, atol=ATOL),
                f"{row} {label}: current max abs err {cur_err}")
        # the kernel's spikes are exactly its own current (the decayed
        # state it decided on added), thresholded
        own = (decayed(k_c, k_used) if state is not None else k_c) >= v_th
        if qp is not None:
            qd = (K.unpack_words(qp) if packing.q else qp)[:m0]
            own &= (K.head_gate(qd, heads, qk).bool() if heads is not None
                    else qd.to(torch.float32).sum(dim=1, keepdim=True) >= qk)
        require(torch.equal(k_spk[:m0, :n0], own.to(torch.int8)),
                f"{row} {label}: spikes are not its current thresholded")
    if not xp.is_floating_point():
        require(all(torch.equal(a, c) for a, c in zip(
            k_first, K.fused_pe_cuda(*args))),
            f"{row} {label}: a second launch changed a bit")
        if packing.current:
            k_c, p_c = k_rest[-1], p_rest[-1]
        elif path != PARITY_OPERANDS:  # a main path's own operands
            emit = (*args[:10], packing._replace(current=True), *args[11:])
            k_c = K.fused_pe_cuda(*emit)[2 + (state is not None)]
            p_c = K.fused_pe_block_ref(*emit)[2 + (state is not None)]
        else:
            k_c = None
        if k_c is not None:
            k_v, p_v = ((decayed(k_c, k_used), decayed(p_c))
                        if state is not None else (k_c, p_c))

            def share(k, p):
                return float(((k - p).abs() / (ATOL + RTOL * p.abs())).max()
                             ) if k.numel() else 0.0
            gap = float((k_v - p_v).abs().max()) if k_v.numel() else 0.0
            parity.note_share(path, row, share(k_c, p_c), share(k_v, p_v),
                              gap)
    parity.note(row, err, int(near.sum()))
    say(f"[parity] {row} {label}: spikes equal away from v_th; "
        f"{int(near.sum())} positions within {NEAR_VTH} of v_th, {flips} of "
        f"them flipped; rate {float(k_spk[:m0, :n0].float().mean()):.4f}; "
        f"silent x blocks {int((vld == 0).sum())}/{vld.numel()}; "
        f"packing {tuple(packing)}; blocks 128x{block_n}x"
        f"{xp.shape[1] * (32 if packing.x else 1) // vld.shape[1]}"
        + ("" if gate is None else f"; skip {gate.skip}")
        + ("" if heads is None else f"; heads {heads}")
        + ("" if state is None else
           f"; state tau {state.tau} {'soft' if state.soft_reset else 'hard'}"
           f" reset, v_next max abs err {err:.3e} away from v_th"))
    return k_spk


def check_chain(torch, K, out, relaunch_into, targs, what: str) -> None:
    """K3's (or K4's) output ``out`` bit-equal to the ascending f32 chain
    on the launch's tile operands ``targs`` (``spike_matmul_chain_ref``:
    each output one sum from +0 over the k its route keeps, the chain
    cuBLAS's product and K2's recheck form); the same launch into a buffer
    filled with NaN (``relaunch_into(buf)``) writes every element, with
    the same bits."""
    chain = K.spike_matmul_chain_ref(*targs)
    require(torch.equal(out, chain),
            f"{what}: {int((out != chain).sum())} of {out.numel()} outputs "
            f"are not the ascending f32 chain's bits")
    buf = torch.full_like(out, float("nan"))
    relaunch_into(buf)
    require(not bool(buf.isnan().any()),
            f"{what}: {int(buf.isnan().sum())} outputs of a NaN-filled "
            f"buffer left unwritten")
    require(torch.equal(buf, out), f"{what}: a second launch differs")


def check_spike_matmul(torch, K, args, parity: Parity, label: str,
                       route: str = "tile", row: Optional[str] = None
                       ) -> None:
    row = row or ("spike_matmul_packed" if args[3] else "spike_matmul")
    out = K.spike_matmul_cuda(*args, route=route)
    targs = tile_args(K, "spike_matmul", args, route)
    ref = K.spike_matmul_block_ref(*targs)
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    require(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
            f"{row} {label}: max abs err {err}")
    check_chain(torch, K, out,
                lambda buf: K.spike_matmul_cuda(*args, route=route, out=buf),
                targs, f"{row} {label}")
    parity.note(row, err)
    say(f"[parity] {row} {label}: max abs err {err:.3e}; bit-equal to the "
        f"ascending f32 chain, every output written; silent x blocks "
        f"{int((args[2] == 0).sum())}/{args[2].numel()}")


PACK_SENTINEL = 0x7F7F7F7F     # an output entry the kernel left unwritten


def misaligned(torch, x):
    """x's values in a contiguous view one byte past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def check_pack(torch, K, args, parity: Parity, label: str) -> None:
    """Words, vld_cnt and occ bit-equal to the plain pack, on x and on a
    16-byte-misaligned copy of it (the byte loop), each launched into
    outputs filled with a sentinel, so that every entry must be written;
    the unpack kernel restores x exactly."""
    (x3,) = args
    ref = K.pack_spikes_ref(x3, with_occ=True)
    m, k = x3.shape[1:]
    for how, xx in (("aligned", x3), ("misaligned", misaligned(torch, x3))):
        out = tuple(torch.full(t.shape, PACK_SENTINEL, dtype=torch.int32,
                               device=x3.device)
                    for t in (ref.words, ref.vld_cnt, ref.occ))
        words, vld, occ = K.pack_spikes_cuda(xx, out=out)
        bad = int((words != ref.words).sum() + (vld != ref.vld_cnt).sum()
                  + (occ != ref.occ).sum())
        require(bad == 0, f"pack_spikes {label} ({how}): {bad} words or map "
                          f"entries differ or were left unwritten")
    back = K.unpack_spikes_cuda(words, m, k)
    lost = int((back != (x3 != 0).to(torch.int8)).sum())
    require(lost == 0, f"pack_spikes {label}: round trip lost {lost}")
    parity.note("pack_spikes", float(bad))
    say(f"[parity] pack_spikes {label}: words, vld_cnt and "
        f"occ bit-equal, aligned and 16-byte misaligned, every entry "
        f"written over a sentinel; round trip exact; words with bit 31 set "
        f"{int((words < 0).sum())}; spikes {int(ref.vld_cnt.sum())}")


# a float output element the unpack kernel left unwritten, or wrote past
# the extent: NaN (int8: 127, no spike value)
UNPACK_SENTINEL = {"torch.int8": 127, "torch.bfloat16": float("nan"),
                   "torch.float32": float("nan")}


def check_unpack(torch, K, args, parity: Parity, label: str,
                 row: str = "unpack_spikes") -> None:
    """The unpacker's launch ``args`` (words, m, k, dtype) into outputs
    inside buffers filled with a sentinel, 16-byte aligned and one element
    past that (the element-wise path): the extent bit-equal to the plain
    version (every element written), the buffer around it untouched."""
    words, m, k, dtype = args
    ref = K.unpack_words(words, dtype)[..., :m, :k]
    n, pad = ref.numel(), 16
    bad = 0
    for how, off in (("aligned", pad), ("misaligned", pad + 1)):
        buf = torch.full((n + 2 * pad,), UNPACK_SENTINEL[str(dtype)],
                         dtype=dtype, device=words.device)
        out = buf[off:off + n].view(ref.shape)
        K.unpack_spikes_cuda(words, m, k, dtype, out=out)
        rest = torch.cat([buf[:off], buf[off + n:]])
        kept = (bool((rest == 127).all()) if dtype == torch.int8
                else bool(rest.isnan().all()))
        bad += int((out != ref).sum())     # a NaN sentinel differs too
        require(kept, f"unpack_spikes {label} {dtype} ({how}): wrote past "
                      f"the extent")
        require(bad == 0, f"unpack_spikes {label} {dtype} ({how}): {bad} "
                          f"elements differ or were left unwritten")
    parity.note(row, float(bad))
    say(f"[parity] {row} {label} {str(dtype)[6:]}: [{m}x{k}] of "
        f"{tuple(words.shape)} words bit-equal, aligned and misaligned, "
        f"every element written over a sentinel, none past the extent")


def check_lif(torch, K, args, parity: Parity, label: str) -> None:
    cur, vp, sp, tau, v_th, soft = args
    k_spk, k_v = K.lif_update_cuda(*args)
    p_spk, p_v = K.lif_update_ref(cur, vp, sp, tau, v_th, soft)
    v = tau * vp * (1.0 - sp) + cur
    near = (v - v_th).abs() < NEAR_VTH
    bad = int(((k_spk != p_spk) & ~near).sum())
    require(bad == 0, f"lif_update {label}: {bad} spikes differ")
    err = float(((k_v - p_v).abs() * ~near).max())
    require(err <= ATOL, f"lif_update {label}: v_next max abs err {err}")
    parity.note("lif_update", err, int(near.sum()))
    say(f"[parity] lif_update {label}: spikes equal away from v_th "
        f"({int(near.sum())} within {NEAR_VTH}); v_next max abs err "
        f"{err:.3e}")


def check_w2ttfs(torch, K, args, parity: Parity, label: str) -> None:
    out = K.w2ttfs_pool_cuda(*args)
    ref = K.w2ttfs_pool_fc_ref(*args)
    err = float((out - ref).abs().max())
    require(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
            f"w2ttfs_pool {label}: max abs err {err}")
    parity.note("w2ttfs_pool", err)
    say(f"[parity] w2ttfs_pool {label}: max abs err {err:.3e}")


def check_dx(torch, K, args, parity: Parity, label: str,
             row: str = "spike_matmul_dx") -> None:
    g, w, v, surrogate, alpha, v_th = args
    dx, dv = K.spike_matmul_dx_cuda(*args)
    rdx, rdv = K.spike_matmul_dx_ref(g, w, v, surrogate=surrogate,
                                     alpha=alpha, v_th=v_th)
    err = float((dx - rdx).abs().max()) if dx.numel() else 0.0
    err_v = float((dv - rdv).abs().max()) if dv.numel() else 0.0
    require(torch.allclose(dx, rdx, rtol=RTOL, atol=ATOL),
            f"spike_matmul_dx {label}: dx max abs err {err}")
    require(torch.allclose(dv, rdv, rtol=RTOL, atol=ATOL),
            f"spike_matmul_dx {label}: dv max abs err {err_v}")
    parity.note(row, max(err, err_v))
    say(f"[parity] {row} {label}: dx max abs err {err:.3e}, dv "
        f"{err_v:.3e}")


def check_dw(torch, K, args, parity: Parity, label: str,
             row: Optional[str] = None) -> None:
    """dw sums over M (up to 262144 rows), so RTOL/ATOL, set for sums of a
    few thousand terms, do not describe it: each element is held instead
    against the product in f64 to the statistical size of the rounding of
    the kernel's own chain of f32 adds, |dw - exact| <= DW_C sqrt(n) u
    (|x|ᵀ|g|), n the longest chain of adds into one output as the
    wrapper's plan cuts it (``dw_plan(...).chain``: a 16-row slice's three
    tensor-core accumulations, the run's adds of its slices' sums, the
    two warpgroups' sum, the partials), u = 2^-24 (the products of x and
    g's exact bf16 terms are exact: x is 0 or 1). One dropped or doubled
    128-row block of x exceeds the limit many times over.
    Also: the same bits on a second launch; and the g rows of every
    all-silent 128-row block of x never enter: NaN written there changes
    no bit of dw. ``max_abs_err`` is against the f32 plain version. A
    packed x (row ``spike_matmul_dw_packed``) must also give the int8
    launch's bits on its unpacked spikes."""
    xa, g, vld = args
    x = dense_x(K, xa)
    row = row or ("spike_matmul_dw_packed" if x is not xa
                  else "spike_matmul_dw")
    dw = K.spike_matmul_dw_cuda(*args)
    if x is not xa:
        require(torch.equal(dw, K.spike_matmul_dw_cuda(x, g, vld)),
                f"{row} {label}: not the int8 launch's bits")
    ref = K.spike_matmul_dw_ref(x, g, vld)
    err = float((dw - ref).abs().max()) if dw.numel() else 0.0
    chain = K.dw_plan(x.shape[0], x.shape[1], g.shape[1]).chain
    x64, g64 = x.to(torch.float64), g.to(torch.float64)
    exact = x64.T @ g64
    limit = DW_C * math.sqrt(chain) * 2.0 ** -24 * (
        x64.abs().T @ g64.abs())
    excess = (dw.to(torch.float64) - exact).abs() - limit
    used = float(((dw.to(torch.float64) - exact).abs()
                  / limit.clamp_min(1e-300)).max()) if dw.numel() else 0.0
    require(not bool((excess > 0).any()),
            f"{row} {label}: {int((excess > 0).sum())} elements "
            f"beyond its limit, the worst {used:.3e} of it (n = {chain}; "
            f"max abs err vs plain {err})")
    require(torch.equal(dw, K.spike_matmul_dw_cuda(*args)),
            f"{row} {label}: a second launch gave other bits")
    silent = (vld == 0).all(dim=1).repeat_interleave(128)[:x.shape[0]]
    g_nan = g.clone()
    g_nan[silent] = float("nan")
    require(torch.equal(dw, K.spike_matmul_dw_cuda(xa, g_nan, vld)),
            f"{row} {label}: a silent tile contributed")
    parity.note(row, err)
    say(f"[parity] {row} {label}: max abs err vs plain {err:.3e}; "
        f"worst error {used:.3e} of its limit (n = "
        f"{chain}); bit-equal across launches; silent x blocks "
        f"{int((vld == 0).sum())}/{vld.numel()} contribute exactly 0")


def check_qk(torch, K, args, parity: Parity, label: str) -> None:
    q, k, threshold = args
    out = K.qk_attention_cuda(*args)
    bad = int((out != K.qk_attention_ref(q, k, threshold=threshold)).sum())
    require(bad == 0, f"qk_attention {label}: {bad} elements differ")
    parity.note("qk_attention", float(bad))
    # a measured row count, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
    rows_on = float((q.to(torch.float32).sum(dim=1) >= threshold).float()
                    .mean()) if q.shape[0] else 0.0
    say(f"[parity] qk_attention {label}: bit-equal; rows kept {rows_on:.4f}")


def check_spike_matmul_gated(torch, K, args, parity: Parity, label: str
                             ) -> None:
    """A main-path gated launch: against its plain version, and bit-equal
    to the ascending f32 chain."""
    out = K.spike_matmul_gated_cuda(*args)
    ref = K.spike_matmul_gated_block_ref(*args)
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    require(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
            f"spike_matmul_gated {label}: max abs err {err}")
    check_chain(torch, K, out,
                lambda buf: K.spike_matmul_gated_cuda(*args, out=buf), args,
                f"spike_matmul_gated {label}")
    parity.note("spike_matmul_gated", err)
    say(f"[parity] spike_matmul_gated {label}: max abs err {err:.3e}; "
        f"bit-equal to the ascending f32 chain")


def check_dw_gated(torch, K, args, parity: Parity, label: str) -> None:
    """A main-path gated dw launch: bit-equal to the dense-skip dw on the
    int8 spikes (a packed x: row ``spike_matmul_dw_gated_packed``)."""
    xa, g, gate = args
    x = dense_x(K, xa)
    row = ("spike_matmul_dw_gated_packed" if x is not xa
           else "spike_matmul_dw_gated")
    dw = K.spike_matmul_dw_gated_cuda(*args)
    require(torch.equal(dw, K.spike_matmul_dw_cuda(x, g, K.vld_map(x))),
            f"{row} {label}: not the int8 dense skip's bits")
    err = float((dw - K.spike_matmul_dw_gated_ref(*args)).abs().max()) \
        if dw.numel() else 0.0
    parity.note(row, err)
    say(f"[parity] {row} {label}: bit-equal to the int8 dense skip; max abs "
        f"err vs plain {err:.3e}")


def dense_x(K, x):
    """A packed dw operand as its logical int8 map; an int8 one as it is."""
    if isinstance(x, K.PackedSpikes):
        return K.unpack_words(x.words)[:x.shape[0], :x.shape[1]].contiguous()
    return x


def flash_gate(torch, K, out, q, k, v, causal) -> tuple[bool, float, float]:
    """K9's output ``out`` against its plain version's f32 result on the
    same operands (taken before the plain version rounds it to q's dtype):
    within rtol = atol = 1e-5, for IEEE f32 sums in another order, and for
    a bf16 output within half a bf16 ulp more (2**-8 of the value), for its
    one rounding to nearest; a truncating rounding, or a lost tile, does
    not fit. Returns (ok, max abs err, rtol)."""
    ref = K.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    rtol = 1e-5 if out.dtype == torch.float32 else 2.0 ** -8 + 1e-5
    err = float((out.float() - ref).abs().max())
    ok = (bool(torch.isfinite(out).all())
          and torch.allclose(out.float(), ref, rtol=rtol, atol=1e-5))
    return ok, err, rtol


def attention_f64(torch, q, k, v, causal):
    """Softmax attention of q [B,S,H,D], k and v [B,S,Hkv,D] in f64: the
    exact result of the operands as given, to within f64 rounding."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qh = q.double().transpose(1, 2)
    kh, vh = (t.double().repeat_interleave(g, dim=2).transpose(1, 2)
              for t in (k, v))
    sc = (qh @ kh.transpose(-1, -2)) * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones((s, s), dtype=torch.bool,
                                        device=q.device).tril(), -1e300)
    return (torch.softmax(sc, dim=-1) @ vh).transpose(1, 2)


def flash_witness(torch, K, out, q, k, v, causal) -> tuple[bool, float,
                                                            float]:
    """K9's f32 output ``out`` and its plain version's f32 result, each
    against the f64 result (``attention_f64``): within twice the plain
    version's own error. Scores far from unit scale are where the f32
    gate against the plain version cannot hold: the plain version scales
    the product, the reference's kernel (and so the scalar route) scales q
    first, and each rounds s (about 2**-24 |s|) where p = exp(s - m) turns
    an error in s into the same relative error in p. JAX's own kernel
    meets the same rule (``tests/test_torch_attention.py``). Returns (ok,
    the kernel's max abs error, the plain version's)."""
    exact = attention_f64(torch, q, k, v, causal)
    plain = K.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    err = float((out.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    ok = bool(torch.isfinite(out).all()) and err <= 2 * err_plain
    return ok, err, err_plain


def check_flash_scaled(torch, K, gen, dev) -> None:
    """K9 on q scaled by 8 (``K9_SCALED``), f32 and bf16, on every route:
    f32 held to ``flash_witness``, bf16 to ``flash_gate``; each route's and
    the plain version's max abs error against the f64 result printed, and
    at f32 the kernel's distance to the plain version in units of the f32
    gate (information: above 1 where the scale is no power of two)."""
    for dtype in (torch.float32, torch.bfloat16):
        for s, h, hkv, d, causal in K9_SCALED:
            q = (torch.randn((1, s, h, d), generator=gen, device=dev)
                 * 8).to(dtype)
            k = torch.randn((1, s, hkv, d), generator=gen, device=dev).to(
                dtype)
            v = torch.randn((1, s, hkv, d), generator=gen, device=dev).to(
                dtype)
            label = (f"scaled x8 {str(dtype)[6:]} S {s} H {h}/{hkv} D {d} "
                     f"{'causal' if causal else 'full'}")
            for route in flash_routes(K, q):
                out = K.flash_attention_cuda(q, k, v, causal, route=route)
                ok, err, err_plain = flash_witness(torch, K, out, q, k, v,
                                                   causal)
                if dtype == torch.float32:
                    ref = K.attention_ref(q, k, v, causal=causal)
                    ratio = float(((out - ref).abs()
                                   / (1e-5 + 1e-5 * ref.abs())).max())
                    note = (f"; against the plain version {ratio:.3f} of "
                            f"the f32 gate (rtol = atol = 1e-5)")
                else:
                    ok, _, _ = flash_gate(torch, K, out, q, k, v, causal)
                    note = "; flash_gate met"
                require(ok, f"flash_attention {label} ({route} route): max "
                            f"abs err {err} against f64, the plain "
                            f"version's {err_plain}")
                say(f"[parity] flash_attention {label} ({route} route): max "
                    f"abs err against f64 {err:.3e}, the plain f32 "
                    f"version's {err_plain:.3e}{note}")


def flash_routes(K, q) -> tuple:
    """The routes K9 can take for q: at bf16 and D % 8 == 0 both
    (``pick_route``'s, the wgmma route, first), else the scalar route."""
    return (("wgmma", "scalar") if K.flash_pick_route(q) == "wgmma"
            else ("scalar",))


def check_flash(torch, K, args, parity: Parity, label: str,
                route=None) -> None:
    """K9 on ``route`` (``pick_route``'s by default) against its plain
    version on the same operands."""
    route = route or K.flash_pick_route(args[0])
    out = K.flash_attention_cuda(*args, route=route)
    ok, err, rtol = flash_gate(torch, K, out, *args)
    require(ok, f"flash_attention {label} ({route} route): max abs err "
                f"{err}")
    parity.note(K9_ROW[route], err)
    say(f"[parity] flash_attention {label} ({route} route): max abs err "
        f"{err:.3e} against the plain f32 result (rtol {rtol:.3e}, atol "
        f"1e-05)")


CHECKS = {"fused_pe": check_fused_pe, "spike_matmul": check_spike_matmul,
          "fused_pe_gated": check_fused_pe,
          "spike_matmul_gated": check_spike_matmul_gated,
          "spike_matmul_dw_gated": check_dw_gated,
          "lif_update": check_lif, "w2ttfs_pool": check_w2ttfs,
          "pack_spikes": check_pack, "unpack_spikes": check_unpack,
          "spike_matmul_dx": check_dx, "spike_matmul_dw": check_dw,
          "qk_attention": check_qk, "flash_attention": check_flash}

# (label, M, K, N, residual, q mask) of every fused PE pass on the int8 main
# path (batch 256), plus a ragged one
FUSED_PE_SHAPES = [
    ("res1.conv1", 262144, 576, 64, None, False),
    ("res1.conv2", 262144, 576, 64, "int8", False),
    ("res2.conv1", 65536, 576, 128, None, False),
    ("res2.conv2", 65536, 1152, 128, "f32", False),
    ("res3.conv1", 16384, 1152, 256, None, False),
    ("res3.conv2", 16384, 2304, 256, "f32", False),
    ("res4.conv1", 4096, 2304, 512, None, False),
    ("res4.conv2", 4096, 4608, 512, "f32", False),
    ("qkf.q", 4096, 512, 512, None, False),
    ("qkf.k", 4096, 512, 512, None, True),
    ("qkf.proj", 4096, 512, 512, "int8", False),
    ("ragged", 4059, 500, 300, "f32", True),
]
# the packed main path: x, q, the spike residual and the output packed;
# each 3x3 tap's channels are padded to 128, so K is 9 * 128 where the int8
# path has 9 * 64 (res1, res2.conv1)
FUSED_PE_PACKED_SHAPES = [
    ("res1.conv1", 262144, 1152, 64, None, False),
    ("res1.conv2", 262144, 1152, 64, "packed", False),
    ("res2.conv1", 65536, 1152, 128, None, False),
    ("res2.conv2", 65536, 1152, 128, "f32", False),
    ("res3.conv1", 16384, 1152, 256, None, False),
    ("res3.conv2", 16384, 2304, 256, "f32", False),
    ("res4.conv1", 4096, 2304, 512, None, False),
    ("res4.conv2", 4096, 4608, 512, "f32", False),
    ("qkf.q", 4096, 512, 512, None, False),
    ("qkf.k", 4096, 512, 512, None, True),
    ("qkf.proj", 4096, 512, 512, "packed", False),
    ("ragged", 4059, 500, 300, "packed", True),
]
SPIKE_MATMUL_SHAPES = [
    ("res2.sc", 65536, 64, 128), ("res3.sc", 16384, 128, 256),
    ("res4.sc", 4096, 256, 512), ("ragged", 4059, 200, 300),
]
# packed shortcut patches: the 1x1 tap's channels padded to 128
SPIKE_MATMUL_PACKED_SHAPES = [
    ("res2.sc", 65536, 128, 128), ("res3.sc", 16384, 128, 256),
    ("res4.sc", 4096, 256, 512), ("ragged", 4059, 200, 300),
]
# [items, M, K] spike maps packed on the main path (the first LIF's
# tokens, batch 256 at 32x32x64; at T = 4 a stateful pass's four steps at
# each width) and ragged ones
PACK_SHAPES = [("first LIF", 1, 262144, 64), ("res1 T=4", 4, 262144, 64),
               ("res2 T=4", 4, 65536, 128), ("res3 T=4", 4, 16384, 256),
               ("res4 T=4", 4, 4096, 512), ("ragged", 2, 4059, 300),
               ("ragged", 3, 130, 33), ("ragged", 2, 129, 640)]
DENSITIES = (0.0, 0.1, 0.5)
# (images, H = W, C, window, classes) of the head: the main path's, a
# CIFAR-100 head on it, and a small one
HEAD_SHAPES = ((256, 4, 512, 4, 10), (256, 4, 512, 4, 100), (5, 8, 64, 4, 10))


def parity_fused_pe(torch, K, gen, dev, parity, shapes, packed: bool
                    ) -> None:
    for label, m, k, n, res, with_q in shapes:
        for p in DENSITIES:
            x = rand_spikes(torch, gen, m, k, p, dev)
            w = torch.randn((k, n), generator=gen, device=dev) \
                * (2.0 / math.sqrt(k))
            b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=dev)
            r = None
            if res == "f32":
                r = 0.5 * torch.randn((m, n), generator=gen, device=dev)
            elif res is not None:
                r = rand_spikes(torch, gen, m, n, 0.3, dev)
                if res == "packed":
                    r = K.pack_spikes_ref(r)
            # Q rows are sparse enough that the mask cuts some of them
            q = (rand_spikes(torch, gen, m, n, 0.002, dev) if with_q
                 else None)
            kw = dict(bias=b, v_th=V_TH, qk_threshold=1.0)
            int8 = K.fused_pe_operands(
                x, w, residual=(K.unpack_spikes_ref(r) if res == "packed"
                                else r), q=q, **kw)
            if packed:
                x = K.pack_spikes_ref(x)
                q = None if q is None else K.pack_spikes_ref(q)
            args = K.fused_pe_operands(
                x, w, residual=r, q=q,
                out_format="packed" if packed else "dense", **kw)
            tag = f"{label} [{m}x{k}x{n}] density {p}"
            check_fused_pe(torch, K, args, parity, tag)
            if packed:   # the packed launch gives the int8 launch's bits
                k_p, k_i = K.fused_pe_cuda(*args), K.fused_pe_cuda(*int8)
                require(torch.equal(K.unpack_words(k_p[0]), k_i[0])
                        and torch.equal(k_p[1], k_i[1]),
                        f"fused_pe_packed {tag}: not the int8 launch's "
                        f"spikes and vld_next")
                say(f"[parity] fused_pe_packed {tag}: spikes and vld_next "
                    f"bit-equal to the int8 launch")


# the LIF state (T > 1) at every pass shape of the int8 main path: (soft
# reset, tau, packed x / spike residual / q / out, emit_current), each of
# them at every shape; v_prev ~ randn, s_prev ~ Bernoulli(0.5)
STATE_COMPOSITIONS = [(False, 0.5, False, False), (True, 0.7, False, True),
                      (False, 0.7, True, False), (True, 0.5, True, True)]


def parity_state(torch, K, gen, dev, parity: Parity) -> None:
    """The stateful fused PE (``check_fused_pe`` with its state), and each
    packed launch bit-equal to the int8 launch on the same spikes: the
    spike map, vld_next, v_next and the emitted current."""
    for i, (label, m, k, n, res, with_q) in enumerate(FUSED_PE_SHAPES):
        p = DENSITIES[1 + i % 2]
        x = rand_spikes(torch, gen, m, k, p, dev)
        w = torch.randn((k, n), generator=gen, device=dev) \
            * (2.0 / math.sqrt(k))
        b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=dev)
        r = None
        if res == "f32":
            r = 0.5 * torch.randn((m, n), generator=gen, device=dev)
        elif res is not None:
            r = rand_spikes(torch, gen, m, n, 0.3, dev)
        q = rand_spikes(torch, gen, m, n, 0.002, dev) if with_q else None
        v = torch.randn((m, n), generator=gen, device=dev)
        sp = (torch.rand((m, n), generator=gen, device=dev) < 0.5).to(
            torch.int8)
        for soft, tau, packed, emit in STATE_COMPOSITIONS:
            kw = dict(bias=b, v_th=V_TH, qk_threshold=1.0, v_prev=v,
                      s_prev=sp, tau=tau, soft_reset=soft,
                      emit_current=emit)
            tag = (f"{label} [{m}x{k}x{n}] density {p} tau {tau} "
                   f"{'soft' if soft else 'hard'} reset"
                   + (" emit_current" if emit else ""))
            int8 = K.fused_pe_operands(x, w, residual=r, q=q, **kw)
            if not packed:
                check_fused_pe(torch, K, int8, parity, tag)
                continue
            pk = K.fused_pe_operands(
                K.pack_spikes_ref(x), w,
                residual=(K.pack_spikes_ref(r) if res == "int8" else r),
                q=None if q is None else K.pack_spikes_ref(q),
                out_format="packed", **kw)
            check_fused_pe(torch, K, pk, parity, tag + " packed")
            k_p, k_i = K.fused_pe_cuda(*pk), K.fused_pe_cuda(*int8)
            require(torch.equal(K.unpack_words(k_p[0]), k_i[0])
                    and all(torch.equal(a, c) for a, c in zip(k_p[1:],
                                                               k_i[1:])),
                    f"fused_pe_state_packed {tag}: not the int8 launch's "
                    f"spikes, vld_next, v_next and current")
            say(f"[parity] fused_pe_state_packed {tag}: spikes, vld_next, "
                f"v_next" + (" and current" if emit else "")
                + " bit-equal to the int8 launch")


# KD training's backward launches at the BN-folded graph's shapes
# (batch 256): dx and dw of the 13 fused PE passes and the 3 shortcut
# matmuls (M, K, N), and the QK mask of the unfused graph (rows, D)
DX_SHAPES = ([(label, m, k, n) for label, m, k, n, _, _ in FUSED_PE_SHAPES]
             + SPIKE_MATMUL_SHAPES)
QK_SHAPES = [("qkf", 4096, 512), ("ragged", 900, 200)]
SURROGATES = ("atan", "sigmoid", "triangle", "rect")


def parity_training(torch, K, gen, dev, parity: Parity) -> None:
    for label, m, k, n in DX_SHAPES:
        g = torch.randn((m, n), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) \
            * (2.0 / math.sqrt(k))
        v = 1.0 + 0.5 * torch.randn((m, n), generator=gen, device=dev)
        for surrogate in SURROGATES:
            check_dx(torch, K, (g, w, v, surrogate, 2.0, V_TH), parity,
                     f"{label} [{m}x{n}] @ [{k}x{n}]^T {surrogate}")
        check_dx(torch, K, (g, w, None, "atan", 2.0, V_TH), parity,
                 f"{label} [{m}x{n}] @ [{k}x{n}]^T without v")
        for p in DENSITIES:
            x = rand_spikes(torch, gen, m, k, p, dev)
            check_dw(torch, K, (x, g, K.vld_map(x)), parity,
                     f"{label} [{m}x{k}]^T @ [{m}x{n}] density {p}")
            # packed_in: the words of the same spikes, the int8 launch's bits
            check_dw(torch, K, (K.pack_spikes_ref(x), g, K.vld_map(x)),
                     parity, f"{label} [{m}x{k}]^T @ [{m}x{n}] density {p} "
                     f"packed x")
    for label, rows, d in QK_SHAPES:
        for p in DENSITIES:
            q = rand_spikes(torch, gen, rows, d, p, dev)
            k = rand_spikes(torch, gen, rows, d, 0.3, dev)
            for dtype in (torch.float32, torch.int8):
                for threshold in (1.0, 0.1 * d):
                    check_qk(torch, K, (q.to(dtype), k.to(dtype), threshold),
                             parity, f"{label} [{rows}x{d}] {dtype} q "
                             f"density {p} threshold {threshold}")
    for label, m, k, n, res, with_q in FUSED_PE_SHAPES:
        for p in DENSITIES:
            x = rand_spikes(torch, gen, m, k, p, dev)
            w = torch.randn((k, n), generator=gen, device=dev) \
                * (2.0 / math.sqrt(k))
            b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=dev)
            r = (0.5 * torch.randn((m, n), generator=gen, device=dev)
                 if res is not None else None)
            q = (rand_spikes(torch, gen, m, n, 0.002, dev) if with_q
                 else None)
            for out_format in ("dense", "packed"):
                args = K.fused_pe_operands(
                    x, w, bias=b, residual=r, q=q, v_th=V_TH,
                    qk_threshold=1.0, out_format=out_format,
                    emit_current=True)
                check_fused_pe(torch, K, args, parity,
                               f"{label} [{m}x{k}x{n}] density {p} "
                               f"{out_format} out")


# the gated routes (skip="gated" and "two_level") at silent-block fractions
# 0, 0.5, 0.9 and 1.0: (label, M, K, N, block_k, block_n) at main-path
# shapes with both block widths the autotuner can plan, and a ragged one
GATED_SILENT = (0.0, 0.5, 0.9, 1.0)
GATED_SHAPES = [
    ("res2.conv2", 65536, 1152, 128, 128, 128),
    ("res3.conv1 wide", 16384, 1152, 256, 128, 256),
    ("res4.conv1 k256", 4096, 2304, 512, 256, 256),
    ("qkf.k k256", 4096, 512, 512, 256, 128),
    ("ragged", 4059, 500, 300, 128, 128),
]
GATED_DW_SHAPES = [("res1.conv1", 262144, 576, 64),
                   ("res3.conv2", 16384, 2304, 256),
                   ("qkf.k", 4096, 512, 512), ("ragged", 4059, 500, 300)]
GATED_SKIPS = ("gated", "two_level")


def gated_spikes(torch, gen, m: int, k: int, silent: float, block_k: int,
                 dev, density: float = 0.3):
    """Seeded 0/1 int8 map whose (128, block_k) blocks are silent with
    probability ``silent``: row block 0 wholly silent when ``silent`` > 0
    (nact = 0 there), and inside every block the 32-column stripes
    (s + row block) % 3 == 0 silent, clustered, the two-level skip's
    target."""
    x = torch.rand((m, k), generator=gen, device=dev) < density
    gm, gk = -(-m // 128), -(-k // block_k)
    keep = torch.rand((gm, gk), generator=gen, device=dev) >= silent
    if silent > 0:
        keep[0] = False
    rb = torch.arange(gm, device=dev)
    stripe_on = ((torch.arange(-(-k // 32), device=dev)[None, :]
                  + rb[:, None]) % 3) != 0
    rows = torch.arange(m, device=dev) // 128
    cols = torch.arange(k, device=dev)
    x &= keep[rows][:, cols // block_k]
    x &= stripe_on[rows][:, cols // 32]
    return x.to(torch.int8)


def check_gated_matmul(torch, K, x, w, block_n: int, block_k: int, skip: str,
                       parity: Parity, label: str) -> None:
    """The gated route against its plain version, bit-equal to the
    ascending f32 chain, and bit-equal to the dense-skip route on the same
    operands."""
    args = K.spike_matmul_operands(x, w, block_n=block_n, block_k=block_k,
                                   skip=skip)
    dense = K.spike_matmul_operands(x, w, block_n=block_n, block_k=block_k)
    out = K.spike_matmul_gated_cuda(*args)
    ref = K.spike_matmul_gated_block_ref(*args)
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    require(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
            f"spike_matmul_gated {label}: max abs err {err}")
    check_chain(torch, K, out,
                lambda buf: K.spike_matmul_gated_cuda(*args, out=buf), args,
                f"spike_matmul_gated {label}")
    require(torch.equal(out, K.spike_matmul_cuda(*dense)),
            f"spike_matmul_gated {label}: not bit-equal to the dense skip")
    parity.note("spike_matmul_gated", err)
    gate = args[2]
    say(f"[parity] spike_matmul_gated {label}: max abs err {err:.3e}; "
        f"bit-equal to the ascending f32 chain and to the dense skip; "
        f"active blocks {int(gate.nact.sum())}/{gate.kmap.numel()}, rows "
        f"with nact = 0 {int((gate.nact == 0).sum())}")


def check_gated_fused_pe(torch, K, fused_kw: dict, parity: Parity,
                         label: str) -> None:
    """The gated fused PE against its plain version (``check_fused_pe``),
    and its spikes, vld_next and current bit-equal to the dense skip's."""
    args = K.fused_pe_operands(**fused_kw)
    dense = K.fused_pe_operands(**dict(fused_kw, skip="dense"))
    check_fused_pe(torch, K, args, parity, label)
    k_out = K.fused_pe_cuda(*args)
    d_out = K.fused_pe_cuda(*dense)
    require(all(torch.equal(a, b) for a, b in zip(k_out, d_out)),
            f"fused_pe_gated {label}: not bit-equal to the dense skip")
    say(f"[parity] fused_pe_gated {label}: spikes, vld_next"
        + (" and current" if len(k_out) > 2 else "")
        + " bit-equal to the dense skip")


def check_gated_dw(torch, K, x, g, skip: str, parity: Parity,
                   label: str, packed: bool = False) -> None:
    """The gated dw bit-equal to the int8 dense-skip dw (and so within
    ``check_dw``'s limit of the exact product), against its plain
    version, and blind to NaN in the g rows of wholly silent row blocks;
    with ``packed`` on x's packed words (row
    ``spike_matmul_dw_gated_packed``)."""
    row = "spike_matmul_dw_gated_packed" if packed else "spike_matmul_dw_gated"
    vld = K.vld_map(x)
    xa = K.pack_spikes_ref(x, with_occ=True) if packed else x
    gate = K.dw_gate(xa, vld, skip)
    dw = K.spike_matmul_dw_gated_cuda(xa, g, gate)
    ref = K.spike_matmul_dw_gated_ref(xa, g, gate)
    err = float((dw - ref).abs().max()) if dw.numel() else 0.0
    require(torch.equal(dw, K.spike_matmul_dw_cuda(x, g, vld)),
            f"{row} {label}: not bit-equal to the int8 dense skip")
    chain = K.dw_plan(x.shape[0], x.shape[1], g.shape[1]).chain
    x64, g64 = x.to(torch.float64), g.to(torch.float64)
    limit = DW_C * math.sqrt(chain) * 2.0 ** -24 * (
        x64.abs().T @ g64.abs())
    require(not bool(((dw.to(torch.float64) - x64.T @ g64).abs()
                      > limit).any()),
            f"{row} {label}: beyond its limit (max abs err vs plain {err})")
    silent = (vld == 0).all(dim=1).repeat_interleave(128)[:x.shape[0]]
    g_nan = g.clone()
    g_nan[silent] = float("nan")
    require(torch.equal(dw, K.spike_matmul_dw_gated_cuda(xa, g_nan, gate)),
            f"{row} {label}: a silent tile contributed")
    parity.note(row, err)
    say(f"[parity] {row} {label}: max abs err vs plain "
        f"{err:.3e}; bit-equal to the dense skip; NaN in {int(silent.sum())}"
        f" silent g rows changes no bit; active blocks "
        f"{int(gate.nact.sum())}/{gate.kmap.numel()}")


def parity_gated(torch, K, gen, dev, parity: Parity) -> None:
    for label, m, k, n, block_k, block_n in GATED_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) \
            * (2.0 / math.sqrt(k))
        b = 0.6 + 0.4 * torch.randn((n,), generator=gen, device=dev)
        for silent in GATED_SILENT:
            x = gated_spikes(torch, gen, m, k, silent, block_k, dev)
            xpk = K.pack_spikes_ref(x, block_k=block_k)
            r = 0.5 * torch.randn((m, n), generator=gen, device=dev)
            rs = K.pack_spikes_ref(rand_spikes(torch, gen, m, n, 0.3, dev),
                                   block_k=block_n)
            q = rand_spikes(torch, gen, m, n, 0.002, dev)
            v = torch.randn((m, n), generator=gen, device=dev)
            sp = (torch.rand((m, n), generator=gen, device=dev) < 0.5).to(
                torch.int8)
            for skip in GATED_SKIPS:
                tag = (f"{label} [{m}x{k}x{n}] blocks 128x{block_n}x{block_k}"
                       f" silent {silent} {skip}")
                for packed, xx in (("int8", x), ("packed", xpk)):
                    check_gated_matmul(torch, K, xx, w, block_n, block_k,
                                       skip, parity, f"{tag} {packed} x")
                base = dict(w=w, bias=b, v_th=V_TH, qk_threshold=1.0,
                            block_n=block_n, block_k=block_k, skip=skip)
                check_gated_fused_pe(torch, K, dict(
                    base, x=x, residual=r, q=q, out_format="dense",
                    emit_current=True), parity, f"{tag} int8 in/out, f32 "
                    f"residual, q, emit_current")
                check_gated_fused_pe(torch, K, dict(
                    base, x=xpk, residual=rs, q=K.pack_spikes_ref(q),
                    out_format="packed"), parity, f"{tag} packed in/out, "
                    f"packed residual and q")
                # with the LIF state: the same routes, the same bits
                state = dict(v_prev=v, s_prev=sp, tau=0.7, soft_reset=True)
                check_gated_fused_pe(torch, K, dict(
                    base, x=x, residual=r, q=q, out_format="dense",
                    emit_current=True, **state), parity,
                    f"{tag} int8 in/out, f32 residual, q, emit_current, "
                    f"LIF state")
                check_gated_fused_pe(torch, K, dict(
                    base, x=xpk, residual=rs, q=K.pack_spikes_ref(q),
                    out_format="packed", **dict(state, soft_reset=False,
                                                tau=0.5)), parity,
                    f"{tag} packed in/out, packed residual and q, LIF state")
    for label, m, k, n in GATED_DW_SHAPES:
        g = torch.randn((m, n), generator=gen, device=dev)
        for silent in GATED_SILENT:
            x = gated_spikes(torch, gen, m, k, silent, 128, dev)
            for skip in GATED_SKIPS:
                for packed in (False, True):
                    check_gated_dw(torch, K, x, g, skip, parity,
                                   f"{label} [{m}x{k}]^T @ [{m}x{n}] silent "
                                   f"{silent} {skip}"
                                   + (" packed x" if packed else ""), packed)


# the spiking LM's fused PE pass at qwen3-1.7b's width (K = d_model 2048):
# (h, dh) of the head-blocked mask, None for the wq pass (no q); dh 128,
# 64 and 16 divide the 128-wide tile, 48 does not (a head straddles two
# tiles, N = 2016 leaves a ragged column tile); decode's 16 rows and a
# ragged 2000-row prefill
LM_PE_HEADS = (None, (16, 128), (32, 64), (128, 16), (42, 48))
LM_PE_ROWS = (16, 2000)
LM_PE_K = 2048


def parity_lm_pe(torch, K, gen, dev, parity: Parity) -> None:
    """The head-blocked, dense-activation fused PE pass against its plain
    version: f32 and bf16 x, dense and packed q, int8 and packed out; the
    packed output's map must be the int8 output's, bit for bit."""
    for m in LM_PE_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, LM_PE_K), generator=gen, device=dev).to(dtype)
            for heads in LM_PE_HEADS:
                n = 2048 if heads is None else heads[0] * heads[1]
                w = torch.randn((LM_PE_K, n), generator=gen, device=dev) \
                    / math.sqrt(LM_PE_K)
                qs = (None,)
                thr = 1.0
                if heads is not None:
                    q = (torch.rand((m, n), generator=gen, device=dev)
                         < 0.05).to(torch.int8)
                    qs = (q, K.pack_spikes_ref(q))
                    thr = float(1 + heads[1] // 32)
                for q in qs:
                    maps = []
                    for fmt in ("dense", "packed"):
                        kw = dict(q=q, v_th=V_TH, qk_threshold=thr,
                                  out_format=fmt, heads=heads)
                        args = K.fused_pe_operands(x, w, **kw)
                        qk = ("no q" if q is None else "packed q"
                              if isinstance(q, K.PackedSpikes) else "int8 q")
                        label = (f"[{m}x{LM_PE_K}x{n}] {str(dtype)[6:]} x, "
                                 f"{qk}, {fmt} out")
                        maps.append(check_fused_pe(torch, K, args, parity,
                                                   label))
                        if m <= K.DECODE_ROWS:   # the decode route: its own
                            dec = K.fused_pe_operands(x, w, **kw,  # operands
                                                      route="decode")
                            check_fused_pe(torch, K, dec, parity,
                                           label + ", decode route",
                                           route="decode")
                            require(same_outputs(torch, K.fused_pe_cuda(
                                *dec, route="decode"),
                                K.fused_pe_cuda(*args)),
                                    f"fused_pe_heads {label}: the decode "
                                    f"route differs from the tile route")
                    require(torch.equal(maps[0], maps[1]),
                            f"fused_pe_heads [{m}x{n}] heads {heads}: the "
                            f"packed output is not the int8 output")


def parity_lm_matmul(torch, K, gen, dev, parity: Parity) -> None:
    """K3 at the LM's wo shape on the decode route: int8 and packed x of 16
    and 64 rows with silent 128-column blocks, against the plain version
    and bit for bit against the 128-row tile."""
    for m in (16, 64):
        for p in DENSITIES:
            x = (torch.rand((m, LM_PE_K), generator=gen, device=dev) < p
                 ).to(torch.int8)
            x[:, 256:512] = 0
            w = torch.randn((LM_PE_K, LM_PE_K), generator=gen, device=dev)
            for xx in (x, K.pack_spikes_ref(x)):
                dec = K.spike_matmul_operands(xx, w, route="decode")
                label = (f"LM wo [{m}x{LM_PE_K}x{LM_PE_K}] density {p}, "
                         f"decode route")
                check_spike_matmul(torch, K, dec, parity, label,
                                   route="decode")
                require(torch.equal(K.spike_matmul_cuda(*dec, route="decode"),
                                    K.spike_matmul_cuda(
                                        *K.spike_matmul_tile_operands(dec))),
                        f"{label}: differs from the 128-row tile")


# the LM's training forward: 8 sequences of 128 tokens, and the step's own
# 8 x 129 (the float-x tile's 8-row tail), qwen3-1.7b's wq (16 heads of
# 128) and its grouped wk (8 kv heads, each repeated for the 2 query heads
# of its group)
LM_TRAIN_ROWS = 1024
LM_STEP_ROWS = 8 * 129
LM_HEADS, LM_KV_HEADS, LM_DH = 16, 8, 128


def parity_lm_train_pe(torch, K, gen, dev, parity: Parity) -> None:
    """K2 as the LM's training forward launches it: a dense f32 or bf16 x
    of 1024 rows and of the step's own 1032 with ``emit_current``, wq
    without q, and the grouped wk
    expanded to the query heads with the head-blocked mask of wq's spikes
    (a qk threshold that keeps about half the heads); int8 and packed out.
    ``check_fused_pe``'s gates (spikes and vld_next bit-equal to the plain
    version's away from v_th, the spikes exactly the kernel's own current
    thresholded and masked, the current within RTOL/ATOL of the plain
    version's, whose cuBLAS product sums in another order), the packed map
    equal to the int8 one, and the current bit-equal to the fused
    multiply-add chain over k ascending (``fma_chain``), the kernel's own
    order."""
    n = LM_HEADS * LM_DH
    for rows, dtype in itertools.product((LM_TRAIN_ROWS, LM_STEP_ROWS),
                                         (torch.float32, torch.bfloat16)):
        x = torch.randn((rows, LM_PE_K), generator=gen, device=dev).to(dtype)
        wq = torch.randn((LM_PE_K, n), generator=gen, device=dev) \
            / math.sqrt(LM_PE_K)
        wk = (torch.randn((LM_PE_K, LM_KV_HEADS, 1, LM_DH), generator=gen,
                          device=dev) / math.sqrt(LM_PE_K)).expand(
            LM_PE_K, LM_KV_HEADS, LM_HEADS // LM_KV_HEADS, LM_DH).reshape(
            LM_PE_K, n).contiguous()
        # a parity input's spikes, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
        q = (x.to(torch.float32) @ wq >= V_TH).to(torch.int8)
        for name, w, qq, heads in (("wq", wq, None, None),
                                   ("wk", wk, q, (LM_HEADS, LM_DH))):
            maps = []
            for fmt in ("dense", "packed"):
                args = K.fused_pe_operands(
                    x, w, q=qq, v_th=V_TH, qk_threshold=20.0,
                    out_format=fmt, emit_current=True, heads=heads)
                label = (f"LM training {name} [{rows}x{LM_PE_K}x{n}] "
                         f"{str(dtype)[6:]} x, emitted current, {fmt} out")
                maps.append(check_fused_pe(torch, K, args, parity, label))
            require(torch.equal(maps[0], maps[1]),
                    f"fused_pe_lm_train {name} {rows} {dtype}: the packed "
                    f"output is not the int8 output")
            cur = K.fused_pe_cuda(*args)[2]
            plain = K.fused_pe_block_ref(*args)[2]
            off = int((cur != K.fma_chain(x, w)).sum())
            require(off == 0, f"fused_pe_lm_train {name} {rows} {dtype}: "
                              f"{off} currents differ from the fused "
                              f"multiply-add chain")
            say(f"[parity] fused_pe_lm_train {name} {rows} rows "
                f"{str(dtype)[6:]} x: "
                f"{int((cur != plain).sum())} of {cur.numel()} currents "
                f"differ in some bit from the plain version's (cuBLAS), 0 "
                f"from the fused multiply-add chain over k ascending; packed "
                f"map equal to the int8 one")


def phase_parity(torch, K, dev) -> Parity:
    parity = Parity()
    gen = torch.Generator(device=dev).manual_seed(1234)
    parity_fused_pe(torch, K, gen, dev, parity, FUSED_PE_SHAPES, False)
    parity_fused_pe(torch, K, gen, dev, parity, FUSED_PE_PACKED_SHAPES, True)
    for packed, shapes in ((False, SPIKE_MATMUL_SHAPES),
                           (True, SPIKE_MATMUL_PACKED_SHAPES)):
        for label, m, k, n in shapes:
            for p in DENSITIES:
                x = rand_spikes(torch, gen, m, k, p, dev)
                w = torch.randn((k, n), generator=gen, device=dev)
                if packed:
                    x = K.pack_spikes_ref(x)
                check_spike_matmul(torch, K,
                                   K.spike_matmul_operands(x, w), parity,
                                   f"{label} [{m}x{k}x{n}] density {p}")
    for label, items, m, k in PACK_SHAPES:
        for p in DENSITIES + (1.0,):
            x = torch.stack([rand_spikes(torch, gen, m, k, p, dev)
                             for _ in range(items)])
            if p > 0:
                x[..., 31::32] = 1          # every word's sign bit
            check_pack(torch, K, (x,), parity,
                       f"{label} [{items}x{m}x{k}] density {p}")
            for dtype in (torch.int8, torch.bfloat16, torch.float32):
                check_unpack(torch, K, (K.pack_spikes_ref(x).words, m, k,
                                        dtype), parity,
                             f"{label} [{items}x{m}x{k}] density {p}")
    for numel in (262144 * 64, 1000003):
        for p in DENSITIES:
            cur = 1.0 + torch.randn((numel,), generator=gen, device=dev)
            vp = torch.randn((numel,), generator=gen, device=dev)
            sp = (torch.rand((numel,), generator=gen, device=dev) < p
                  ).to(torch.float32)
            check_lif(torch, K, (cur, vp, sp, 0.5, V_TH, False), parity,
                      f"n={numel} s_prev density {p}")
    for b, h, c, window, classes in HEAD_SHAPES:
        for p in DENSITIES:
            spikes = (torch.rand((b, h, h, c), generator=gen, device=dev)
                      < p)
            feats = (h // window) ** 2 * c
            fc_w = torch.randn((feats, classes), generator=gen, device=dev)
            fc_b = torch.randn((classes,), generator=gen, device=dev)
            for dtype in (torch.int8, torch.bfloat16, torch.float32):
                check_w2ttfs(torch, K, (spikes.to(dtype), fc_w, fc_b, window),
                             parity, f"[{b},{h},{h},{c}] {dtype} window "
                                     f"{window} {classes} classes density {p}")
    parity_state(torch, K, gen, dev, parity)
    parity_training(torch, K, gen, dev, parity)
    parity_gated(torch, K, gen, dev, parity)
    parity_lm_pe(torch, K, gen, dev, parity)
    parity_lm_matmul(torch, K, gen, dev, parity)
    parity_lm_train_pe(torch, K, gen, dev, parity)
    torch.cuda.synchronize()
    parity.print_shares(K, True)
    return parity


# ------------------------------------------------------------ phase 3b
def phase_constants(torch, K, dev) -> dict:
    """The cost model's constants, measured on the card (the values
    ``launch/roofline.py`` carries come from this phase):

      peak_flops        2 M K N over the dense-skip spike matmul's time on
                        an all-active 4096 x 4608 x 512 operand (res4.conv2)
      hbm_bw            a 1 GiB device-to-device copy: 2 GiB over its time
      launch_overhead_s one back-to-back launch of the dense-skip spike
                        matmul on a silent 128 x 128 x 128 tile (the
                        wrapper's ctypes call included)
      gating_overhead_s compact_kmap of resblock 1's [2048, 9] vld map
      subtile_eff       the two-level route with half its stripes clear
                        against the gated route on the same operand:
                        (time gated / 2) / time two-level, at most 1
    """
    gen = torch.Generator(device=dev).manual_seed(77)
    m, k, n = 4096, 4608, 512
    x = (torch.rand((m, k), generator=gen, device=dev) < 0.3).to(torch.int8)
    w = torch.randn((k, n), generator=gen, device=dev)
    args = K.spike_matmul_operands(x, w)
    require(bool((args[2] > 0).all()), "peak operand has a silent block")
    ms = time_cuda(torch, lambda: K.spike_matmul_cuda(*args), reps=20)
    peak = 2.0 * m * k * n / (ms * 1e-3)
    a = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    copy_ms = time_cuda(torch, lambda: b.copy_(a), reps=20)
    hbm = 2.0 * a.numel() * 4 / (copy_ms * 1e-3)
    del a, b
    tiny = K.spike_matmul_operands(
        torch.zeros((128, 128), dtype=torch.int8, device=dev),
        torch.zeros((128, 128), device=dev))
    launch_ms = time_cuda(torch, lambda: K.spike_matmul_cuda(*tiny),
                          reps=500, warmup=20)
    vld = K.vld_map(rand_spikes(torch, gen, 262144, 1152, 0.1, dev))
    gate_ms = time_cuda(torch, lambda: K.compact_kmap(vld), reps=500,
                        warmup=20)
    m2, k2, n2 = 16384, 2304, 256
    x2 = (torch.rand((m2, k2), generator=gen, device=dev) < 0.3)
    x2 &= (torch.arange(k2, device=dev) // 32 % 2 == 0)[None, :]
    x2 = x2.to(torch.int8)
    w2 = torch.randn((k2, n2), generator=gen, device=dev)
    g_args = K.spike_matmul_operands(x2, w2, skip="gated")
    t_args = K.spike_matmul_operands(x2, w2, skip="two_level")
    g_ms = time_cuda(torch, lambda: K.spike_matmul_gated_cuda(*g_args),
                     reps=20)
    t_ms = time_cuda(torch, lambda: K.spike_matmul_gated_cuda(*t_args),
                     reps=20)
    out = {"peak_flops": peak, "hbm_bw": hbm,
           "launch_overhead_s": launch_ms * 1e-3,
           "gating_overhead_s": gate_ms * 1e-3,
           "subtile_eff": min(1.0, 0.5 * g_ms / t_ms)}
    say(f"[constants] dense-skip spike matmul {m}x{k}x{n} all active: "
        f"{ms:.4f} ms, {peak / 1e12:.3f} TFLOP/s; 1 GiB copy {copy_ms:.4f} "
        f"ms, {hbm / 1e12:.3f} TB/s; launch {launch_ms * 1e3:.3f} us; "
        f"compact_kmap [{vld.shape[0]}, {vld.shape[1]}] {gate_ms * 1e3:.3f} "
        f"us; {m2}x{k2}x{n2} half stripes clear: gated {g_ms:.4f} ms, "
        f"two_level {t_ms:.4f} ms, stripe-step efficiency "
        f"{0.5 * g_ms / t_ms:.4f}")
    say(f"[constants] measured {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ phase 4
def init_model(torch, snn_cnn, dev, arch: str = "qkfresnet11",
               quiet_beta=None):
    """The full-width config and its training variables, seed 0, every BN
    beta 0.5, or, with ``quiet_beta``, that beta in the first BN of every
    resblock (the quiet regime)."""
    cfg = snn_cnn.SNNCNNConfig(arch=arch, width_mult=1.0, image_size=32,
                               in_channels=3, num_classes=10)
    gen = torch.Generator(device="cpu").manual_seed(0)
    variables = snn_cnn.init(gen, cfg, device=dev)
    # a random net at full width goes silent by the third resblock; a BN
    # beta of 0.5 keeps every layer firing (per-layer rates 0.24-0.52). A
    # lower beta in each resblock's first BN quiets its s1 map, the operand
    # of its second conv, while the bias and the shortcut keep the block's
    # output firing: the quiet regime of the auto phase
    for p in variables["params"]:
        for key, sub in p.items():
            if key.startswith("bn"):
                sub["bias"].fill_(0.5 if quiet_beta is None or key != "bn1"
                                  else quiet_beta)
    return cfg, variables


def build_model(torch, snn_cnn, dev, arch: str = "qkfresnet11",
                quiet_beta=None):
    cfg, variables = init_model(torch, snn_cnn, dev, arch, quiet_beta)
    return cfg, snn_cnn.fuse_model(variables, cfg)


def run_path(torch, snn_cnn, build_mod, fused, images, cfg, policy: str):
    """One forward of a kernel path, its launch counts set to 0 just
    before it and read just after it."""
    build_mod.reset_launches()
    with build_mod.capture_launches() as captured:
        logits, _, aux = snn_cnn.forward(fused, images, cfg, policy=policy)
        torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    say(f"[e2e] kernel launches in one {policy} forward: {launches}")
    require(launches == EXPECTED_LAUNCHES[policy],
            f"{policy} launch counts {launches} != "
            f"{EXPECTED_LAUNCHES[policy]}")
    return logits, aux, launches, captured


def compare_spikes(aux, ref_aux, label: str, rel_tol: float) -> float:
    """Per-layer spike totals of a kernel path against another run."""
    worst = 0.0
    for key, val in aux["spikes"].items():
        if key not in ref_aux["spikes"]:
            continue
        a, b = float(val), float(ref_aux["spikes"][key])
        rel = abs(a - b) / max(b, 1.0)
        worst = max(worst, rel)
        say(f"[e2e] spikes {key}: {label} {a:.0f} vs {b:.0f} "
            f"(rel diff {rel:.2e})")
        require(rel <= rel_tol, f"{label}: spike total {key} differs by "
                                f"{rel:.2e}")
    return worst


def check_logits(torch, logits, ref_logits, batch: int, label: str) -> None:
    require(tuple(logits.shape) == (batch, 10), f"logits {logits.shape}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    diff = float((logits - ref_logits).abs().max())
    say(f"[e2e] top-1 agreement {label}: {agree:.4f}; max |logit diff| "
        f"{diff:.3e}; logits range [{float(logits.min()):.3f}, "
        f"{float(logits.max()):.3f}]")
    require(agree >= 0.99, f"{label}: top-1 agreement {agree} < 0.99")


def phase_end_to_end(torch, snn_cnn, build_mod, dev, batch: int):
    cfg, fused = build_model(torch, snn_cnn, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.rand((batch, 32, 32, 3), generator=gen, device=dev)
    say(f"[e2e] QKFResNet-11 width 1.0, {len(fused)} layers, "
        f"{sum(t.numel() for p in fused for s in p.values() for t in s.values())}"
        f" parameters, batch {batch}")
    paths = {policy: run_path(torch, snn_cnn, build_mod, fused, images, cfg,
                              policy)
             for policy in ("fused_dense", "fused_packed")}
    ref_logits, _, ref_aux = snn_cnn.forward(fused, images, cfg,
                                             policy="reference")
    torch.cuda.synchronize()
    d_logits, d_aux = paths["fused_dense"][:2]
    p_logits, p_aux = paths["fused_packed"][:2]
    for key, rate in d_aux["rates"].items():
        r = float(rate)
        say(f"[e2e] rate {key}: fused_dense {r:.4f} fused_packed "
            f"{float(p_aux['rates'][key]):.4f} reference "
            f"{float(ref_aux['rates'][key]):.4f}")
        require(0.0 < r < 1.0, f"rate {key} = {r} is not strictly in (0, 1)")
    compare_spikes(d_aux, ref_aux, "fused_dense vs reference", 1e-3)
    compare_spikes(p_aux, d_aux, "fused_packed vs fused_dense", 0.0)
    check_logits(torch, d_logits, ref_logits, batch,
                 "fused_dense vs reference")
    check_logits(torch, p_logits, ref_logits, batch,
                 "fused_packed vs reference")
    say(f"[e2e] fused_packed logits equal fused_dense's: "
        f"{bool(torch.equal(p_logits, d_logits))}")
    for name, args, *_ in paths["fused_packed"][3]:
        if name == "spike_matmul":
            require(args[3] is True,
                    f"a fused_packed {name} launch took int8 operands")
        if name == "fused_pe":
            require(args[10].x and args[10].out,
                    f"a fused_packed {name} launch took int8 operands")
    say(f"[e2e] spike bytes between kernels: fused_dense "
        f"{d_aux['spike_hbm_bytes']}, fused_packed "
        f"{p_aux['spike_hbm_packed_bytes']} (int8 equivalent "
        f"{p_aux['spike_hbm_dense_bytes']}); vld maps reused "
        f"{d_aux['vld_reused']} / {p_aux['vld_reused']}")
    return cfg, fused, images, paths


def phase_vgg(torch, snn_cnn, build_mod, dev, batch: int) -> None:
    """VGG-11 at full width under fused_packed against reference: the
    packed max-pool (a bitwise OR of words) on the card. Parity only."""
    cfg, fused = build_model(torch, snn_cnn, dev, "vgg11")
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.rand((batch, 32, 32, 3), generator=gen, device=dev)
    build_mod.reset_launches()
    logits, _, aux = snn_cnn.forward(fused, images, cfg,
                                     policy="fused_packed")
    torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    say(f"[vgg] VGG-11 width 1.0, batch {batch}, fused_packed launches "
        f"{launches}")
    require(launches["pack_spikes"] == 1 and launches["unpack_spikes"] == 1
            and launches["fused_pe"] == 7 and launches["spike_matmul"] == 0,
            f"VGG-11 launches {launches}")
    ref_logits, _, ref_aux = snn_cnn.forward(fused, images, cfg,
                                             policy="reference")
    torch.cuda.synchronize()
    for key, rate in aux["rates"].items():
        say(f"[vgg] rate {key}: fused_packed {float(rate):.4f} reference "
            f"{float(ref_aux['rates'][key]):.4f}")
    compare_spikes(aux, ref_aux, "VGG-11 fused_packed vs reference", 1e-3)
    check_logits(torch, logits, ref_logits, batch,
                 "VGG-11 fused_packed vs reference")


# ------------------------------------------------------------- phase 4b
# the quiet regime: each resblock's first BN beta lowered to the first of
# these values at which some tuned layer's operand has at most half its
# blocks active and the last layer still fires
QUIET_BETAS = (0.25, 0.0, -0.25, -0.5, -0.75, -1.0, -1.5, -2.0, -3.0, -4.0)
AUTO_POLICIES = ("auto", "auto_packed")


def tuned_layer_names(cfg, snn_cnn) -> list:
    """The matmul sweeps an auto forward plans, in the walk's order."""
    names, conv = [], 0
    for i, layer in enumerate(snn_cnn.build_layers(cfg)):
        kind = layer[0]
        if kind == "conv_bn_lif":
            conv += 1
            if conv > 1:                       # the stem is a cuDNN conv
                names.append(f"layer{i}.conv")
        elif kind == "resblock":
            _, cin, cout, stride = layer
            names.append(f"res{i}.conv1")
            if stride != 1 or cin != cout:
                names.append(f"res{i}.sc")
            names.append(f"res{i}.conv2")
        elif kind == "qkformer":
            names += [f"qkf{i}.{p}" for p in ("q", "k", "proj", "mlp1",
                                               "mlp2")]
    return names


def active_fracs(captured) -> list:
    """Active-block fraction of x in each fused PE / spike matmul launch."""
    # a measured fraction, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
    return [float((args[2] > 0).float().mean()) for name, args, *_ in captured
            if name in ("fused_pe", "spike_matmul")]


def pick_quiet_beta(torch, snn_cnn, build_mod, dev, images) -> float:
    """The first of QUIET_BETAS at which some tuned operand is at most half
    active and the net's last layer still fires (fused_packed forwards)."""
    for beta in QUIET_BETAS:
        cfg, fused = build_model(torch, snn_cnn, dev, quiet_beta=beta)
        with build_mod.capture_launches() as cap:
            _, _, aux = snn_cnn.forward(fused, images, cfg,
                                        policy="fused_packed")
            torch.cuda.synchronize()
        fracs = active_fracs(cap)
        last = float(list(aux["rates"].values())[-1])
        say(f"[auto] resblock BN1 beta {beta}: active-block fractions "
            f"{[round(f, 4) for f in fracs]}; last layer rate {last:.4f}")
        if min(fracs) <= 0.5 and last > 0.0:
            return beta
    raise AssertionError(f"no BN beta of {QUIET_BETAS} gives a quiet, "
                         f"firing net")


def print_plans(names, trace, label: str) -> None:
    require(len(trace) == len(names),
            f"{label}: {len(trace)} plans for {len(names)} tuned layers")
    for name, (m, k, n, fmt, active, occ, plan) in zip(names, trace):
        say(f"[auto] {label} {name} [{m}x{k}x{n}] {fmt}: active_frac "
            f"{active:.4f} occ_frac {occ:.4f} -> {plan.kernels} {plan.skip} "
            f"blocks {plan.block_m}x{plan.block_n}x{plan.block_k} est "
            f"{plan.est_time_s * 1e6:.1f} us")


def run_auto(torch, snn_cnn, build_mod, tuner, fused, images, cfg,
             policy: str, label: str):
    """One auto forward, its launch counts set to 0 just before it and
    read just after it, the tuner's plans traced."""
    tuner.reset()
    tuner.trace = []
    build_mod.reset_launches()
    with build_mod.capture_launches() as captured:
        logits, _, aux = snn_cnn.forward(fused, images, cfg, policy=policy)
        torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    trace, tuner.trace = tuner.trace, None
    print_plans(tuned_layer_names(cfg, snn_cnn), trace, label)
    say(f"[auto] {label}: launches {launches}; {tuner.reads} metadata reads "
        f"on the host, {tuner.read_s * 1e3:.3f} ms")
    return logits, aux, launches, captured, trace


def phase_auto(torch, snn_cnn, build_mod, ops, dev, images, paths) -> dict:
    """QKFResNet-11 at full width under auto and auto_packed at the busy
    regime (every BN beta 0.5) and a quiet one; per layer the plan, the
    measured sparsity and the launches; logits and spikes held to the
    inference gates against reference, and bit-equal to the fixed fused
    policy of the same format where every layer planned a fused kernel.
    Adds each forward to ``paths``; returns regime -> (beta, cfg, fused)
    and each auto forward's plan trace."""
    tuner = ops.get_tuner()
    regimes = {"busy": None,
               "quiet": pick_quiet_beta(torch, snn_cnn, build_mod, dev,
                                        images)}
    say(f"[auto] quiet regime: every resblock's first BN beta "
        f"{regimes['quiet']}, every other BN beta 0.5")
    models, traces = {}, {}
    for regime, beta in regimes.items():
        cfg, fused = build_model(torch, snn_cnn, dev, quiet_beta=beta)
        models[regime] = (beta, cfg, fused)
        ref_logits, _, ref_aux = snn_cnn.forward(fused, images, cfg,
                                                 policy="reference")
        for fixed in ("fused_dense", "fused_packed"):
            if f"{fixed} {regime}" not in paths:
                logits, aux, launches, cap = run_path(
                    torch, snn_cnn, build_mod, fused, images, cfg, fixed)
                paths[f"{fixed} {regime}"] = (logits, aux, launches, cap)
        for policy in AUTO_POLICIES:
            label = f"{policy} {regime}"
            logits, aux, launches, cap, trace = run_auto(
                torch, snn_cnn, build_mod, tuner, fused, images, cfg, policy,
                label)
            paths[label] = (logits, aux, launches, cap)
            traces[label] = trace
            compare_spikes(aux, ref_aux, f"{label} vs reference", 1e-3)
            check_logits(torch, logits, ref_logits, images.shape[0],
                         f"{label} vs reference")
            fixed = "fused_packed" if policy == "auto_packed" \
                else "fused_dense"
            f_logits, f_aux = paths[f"{fixed} {regime}"][:2]
            if all(p.kernels == "fused" for *_, p in trace):
                require(torch.equal(logits, f_logits),
                        f"{label}: every plan fused, logits not {fixed}'s")
                compare_spikes(aux, f_aux, f"{label} vs {fixed}", 0.0)
                say(f"[auto] {label}: every layer planned a fused kernel; "
                    f"logits and spikes bit-equal to {fixed}")
            else:
                say(f"[auto] {label}: "
                    f"{sum(p.kernels == 'reference' for *_, p in trace)} of "
                    f"{len(trace)} layers planned the reference")
    return models, traces


def stack1(t):
    """A kernel-level operand as the [1, ...] one-step train of the ops
    layer (PackedSpikes keep their words and maps)."""
    from repro_torch.core.events import PackedSpikes

    if t is None or not isinstance(t, PackedSpikes):
        return None if t is None else t[None]
    return PackedSpikes(t.words[None], t.vld_cnt[None], (1, *t.shape),
                        t.block_m, t.block_k,
                        None if t.occ is None else t.occ[None])


def phase_explicit(torch, K, build_mod, ops, paths, train_captured):
    """The three gated kernels launched through the ops entry points with
    an explicit ``skip``, on operands the model's own layers produced: the
    most silent fused PE and shortcut launches of the quiet regime's
    fused_packed and fused_dense forwards, and the most silent dw launch of
    a quiet fused_dense+grad step; each output bit-equal to the dense
    skip's. Returns the path tuple of these launches."""
    from repro_torch.kernels.spike_matmul import spike_matmul_dw

    def most_silent(captured, name):
        # a measured fraction, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
        cands = [(float((a[2] > 0).float().mean()), i, a, inp)
                 for i, (n_, a, inp, _) in enumerate(captured) if n_ == name]
        return min(cands, key=lambda c: (c[0], c[1]))

    picks = []
    for fixed in ("fused_packed", "fused_dense"):
        cap = paths[f"{fixed} quiet"][3]
        picks.append((fixed, most_silent(cap, "fused_pe"),
                      most_silent(cap, "spike_matmul")))
    dw_pick = most_silent(train_captured, "spike_matmul_dw")
    build_mod.reset_launches()
    with build_mod.capture_launches() as captured:
        for fixed, (fa, fi, _, finp), (ma, mi, _, minp) in picks:
            x, w, bias, residual, q = finp
            for skip in GATED_SKIPS:
                outs = [ops.fused_pe_layer(
                    ops.SpikeTensor.wrap(stack1(x)), w, bias=bias,
                    residual=None if residual is None
                    else ops.SpikeTensor.wrap(stack1(residual)),
                    q=None if q is None else ops.SpikeTensor.wrap(stack1(q)),
                    policy=fixed, skip=sk) for sk in (skip, "dense")]
                require(torch.equal(outs[0].spikes.data, outs[1].spikes.data)
                        and torch.equal(outs[0].vld_next, outs[1].vld_next),
                        f"explicit fused_pe {skip} ({fixed} launch {fi}) is "
                        f"not the dense skip's")
                mx, mw = minp
                mm = [ops.matmul(ops.SpikeTensor.wrap(mx), mw, policy=fixed,
                                 skip=sk) for sk in (skip, "dense")]
                require(torch.equal(mm[0], mm[1]),
                        f"explicit matmul {skip} ({fixed} launch {mi}) is not "
                        f"the dense skip's")
                say(f"[explicit] {fixed} fused_pe launch {fi} (active blocks "
                    f"{fa:.4f}) and spike_matmul launch {mi} ({ma:.4f}) under "
                    f"skip={skip}: bit-equal to the dense skip")
        da, di, dargs, _ = dw_pick
        x8, g, vld = dargs
        for skip in GATED_SKIPS:
            dws = [spike_matmul_dw(x8, g, vld_cnt=vld, skip=sk)
                   for sk in (skip, "dense")]
            require(torch.equal(dws[0], dws[1]),
                    f"explicit dw {skip} (launch {di}) is not the dense "
                    f"skip's")
            say(f"[explicit] fused_dense+grad dw launch {di} (active blocks "
                f"{da:.4f}) under skip={skip}: bit-equal to the dense skip")
        torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    say(f"[explicit] launches {launches}")
    return None, None, launches, captured


def phase_plans(tuned, names) -> None:
    """The plan the card's cost model gives each full-width layer at every
    sparsity bucket (pure arithmetic; occ_frac 1, as the patch operands
    carry no occ map), forward and backward."""
    from repro_torch.ops.autotune import _BUCKETS, AutoTuner

    tuner = AutoTuner()
    for (m, k, n, fmt, *_), name in zip(tuned, names):
        fwd = []
        for b in _BUCKETS:
            p = tuner.plan_matmul(m, k, n, fmt=fmt, active_frac=b)
            fwd.append(f"{b}:{p.kernels[0]}/{p.skip}/{p.block_n}")
        grad = [f"{b}:{p.kernels[0]}/{p.skip}" for b in _BUCKETS
                for p in [tuner.plan_grad_matmul(m, k, n, fmt=fmt,
                                                 active_frac=b)]]
        say(f"[plans] {name} [{m}x{k}x{n}] {fmt}: forward {' '.join(fwd)}; "
            f"backward {' '.join(grad)}")


# ------------------------------------------------------------------ phase 5
TRAIN_PATHS = [("fold", "reference+grad"), ("fold", "fused_dense+grad"),
               ("fold", "fused_packed+grad"), ("unfused", "reference+grad"),
               ("unfused", "fused_dense+grad")]


def unfused_step_launches(cfg, snn_cnn) -> dict:
    """Kernel launches of one fused_dense+grad step on the unfused graph,
    from the layer list: every conv after the stem and every QKFormer
    linear is one spike matmul forward with one dx and one dw backward;
    every LIF (the stem's, two a resblock, five a QKFormer block) one
    lif_update; one QK mask a QKFormer block; one W2TTFS head."""
    lif = matmul = qk = 0
    for layer in snn_cnn.build_layers(cfg):
        kind = layer[0]
        if kind == "conv_bn_lif":
            lif += 1
            matmul += 0 if lif == 1 else 1          # the stem is a cuDNN conv
        elif kind == "resblock":
            _, cin, cout, stride = layer
            lif += 2
            matmul += 2 + int(stride != 1 or cin != cout)
        elif kind == "qkformer":
            lif += 5
            matmul += 5
            qk += 1
    return {"lif_update": lif, "fused_pe": 0, "spike_matmul": matmul,
            "w2ttfs_pool": 1, "pack_spikes": 0, "unpack_spikes": 0,
            "spike_matmul_dx": matmul, "spike_matmul_dw": matmul,
            "qk_attention": qk, **NO_GATED, **NO_ATTENTION}


def expected_step_launches(graph: str, policy: str, cfg, snn_cnn) -> dict:
    if policy.startswith("reference"):
        return dict.fromkeys(FOLD_STEP_LAUNCHES, 0)
    if graph == "unfused":
        return unfused_step_launches(cfg, snn_cnn)
    out = dict(FOLD_STEP_LAUNCHES)
    if policy.startswith("fused_packed"):
        out["unpack_spikes"] = 13       # each packed fused PE output
    return out


@contextlib.contextmanager
def plain_launchers():
    """Swap every kernel launcher of the unfused training step for its
    plain PyTorch version, and stop the wrappers counting: inside, the
    step runs the same wrappers, operands and autograd on the card with
    no hand-written kernel."""
    from repro_torch.kernels import _build
    import repro_torch.kernels.lif_update.ops as lif_ops
    import repro_torch.kernels.qk_attention.ops as qk_ops
    import repro_torch.kernels.spike_matmul.backward as bwd_ops
    import repro_torch.kernels.spike_matmul.ops as mm_ops
    import repro_torch.kernels.w2ttfs_pool.ops as head_ops

    def dx(g, w, v, surrogate, alpha, v_th):
        return bwd_ops.spike_matmul_dx_ref(g, w, v, surrogate=surrogate,
                                           alpha=alpha, v_th=v_th)

    def matmul(*args, route="tile"):
        return mm_ops.spike_matmul_block_ref(
            *mm_ops.spike_matmul_tile_operands(args))

    swaps = [(mm_ops, "spike_matmul_cuda", matmul),
             (bwd_ops, "spike_matmul_dx_cuda", dx),
             (bwd_ops, "spike_matmul_dw_cuda", bwd_ops.spike_matmul_dw_ref),
             (lif_ops, "lif_update_cuda", lif_ops.lif_update_ref),
             (qk_ops, "qk_attention_cuda",
              lambda q, k, threshold: qk_ops.qk_attention_ref(
                  q, k, threshold=threshold)),
             (head_ops, "w2ttfs_pool_cuda", head_ops.w2ttfs_pool_fc_ref),
             (_build, "count_launch", lambda *args: None)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class TrainPath:
    """One training path: the KD step through ``make_kd_train_step`` and
    the gradient of its first step through ``make_kd_grad_fn`` (the same
    loss and autograd, from the same initial state)."""

    def __init__(self, torch, M, cfg, variables, tcfg, tvar, graph, policy,
                 suffix: str = ""):
        self.torch, self.M = torch, M
        self.graph, self.policy = graph, policy
        self.cfg = dataclasses.replace(cfg, bn_fold=graph == "fold")
        self.variables, self.tcfg, self.tvar = variables, tcfg, tvar
        self.aux = None

        def student(p, s, x, policy=None):
            out = M.snn_cnn.forward({"params": p, "state": s}, x, self.cfg,
                                    train=True, policy=policy)
            self.aux = out[2]
            return out

        def teacher(tp, x):
            return M.ann_cnn.apply(tp, x, tcfg)[0]

        self.student, self.teacher = student, teacher
        kd = M.KDConfig(alpha=0.7)
        self.step = M.trainer.make_kd_train_step(
            student, teacher, tvar, kd=kd, schedule=M.cosine_lr(0.1, 10),
            optimizer="sgd", momentum=0.9, weight_decay=5e-4, policy=policy)
        self.grad_fn = M.trainer.make_kd_grad_fn(student, teacher, tvar,
                                                 kd=kd, policy=policy)
        self.name = f"train {graph} {policy}{suffix}"

    def run(self, batches, build_mod, observe: bool = False) -> None:
        """The steps from the initial state; with ``observe`` each step's
        metrics feed the autotuner (``observe_train_sparsity``)."""
        torch, M = self.torch, self.M
        v = self.variables
        self.batch0 = batches[0]
        _, _, _, grads = self.grad_fn(v["params"], v["state"], batches[0])
        self.grads = M.tree_leaves(grads)
        self.spikes = {k: float(val) for k, val in self.aux["spikes"].items()}
        carry = (v["params"], M.sgd_init(v["params"]), v["state"])
        self.losses, self.launches, self.peak = [], [], []
        self.captured = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build_mod.reset_launches()
            with build_mod.capture_launches() as captured:
                carry, metrics = self.step(carry, batch)
                torch.cuda.synchronize()
            self.launches.append(dict(build_mod.LAUNCHES))
            self.peak.append(torch.cuda.max_memory_allocated())
            if i == 0:
                self.captured = captured
            if observe:
                M.trainer.observe_train_sparsity(metrics)
            self.losses.append(float(metrics["loss"]))
            spikes = " ".join(f"{k}={float(val):.0f}"
                              for k, val in self.aux["spikes"].items())
            say(f"[train] {self.name} step {i}: loss {float(metrics['loss']):.6f} "
                f"ce {float(metrics['ce']):.6f} kl {float(metrics['kl']):.6f} "
                f"lr {float(metrics['lr']):.6f}; spikes {spikes}")
            say(f"[train] {self.name} step {i}: launches {self.launches[-1]}; "
                f"peak memory {self.peak[-1] / 2**30:.3f} GiB")
        self.carry = carry


def kd_setup(torch, M, dev, batch: int):
    """The ResNet-18 teacher (seed 1) and the KD batches of every path."""
    tcfg = M.ann_cnn.ANNCNNConfig(arch="resnet18", width_mult=1.0)
    tvar = M.ann_cnn.init(torch.Generator(device="cpu").manual_seed(1), tcfg,
                          device=dev)
    ds = M.SyntheticImageDataset(num_classes=10, image_size=32, seed=0)
    batches = []
    for i in range(TRAIN_STEPS):
        imgs, labels = ds.batch(i, batch)
        batches.append({"images": torch.tensor(imgs, device=dev),
                        "labels": torch.tensor(labels, device=dev)})
    return tcfg, tvar, batches


def phase_training(torch, M, build_mod, dev, batch: int):
    cfg, variables = init_model(torch, M.snn_cnn, dev)
    tcfg, tvar, batches = kd_setup(torch, M, dev, batch)
    say(f"[train] QKFResNet-11 width 1.0 student "
        f"({sum(p.numel() for p in M.tree_leaves(variables['params']))} "
        f"parameters), ANN ResNet-18 width 1.0 teacher in eval mode, batch "
        f"{batch}, {TRAIN_STEPS} steps from one state per path")
    paths = {}
    for graph, policy in TRAIN_PATHS:
        path = TrainPath(torch, M, cfg, variables, tcfg, tvar, graph, policy)
        path.run(batches, build_mod)
        want = expected_step_launches(graph, policy, path.cfg, M.snn_cnn)
        for i, got in enumerate(path.launches):
            require(got == want, f"{path.name} step {i}: launches {got} != "
                                 f"{want}")
        for loss in path.losses:
            require(math.isfinite(loss), f"{path.name}: loss {loss}")
        paths[graph, policy] = path
    ref = paths["fold", "reference+grad"]
    for policy in ("fused_dense+grad", "fused_packed+grad"):
        compare_training(paths["fold", policy], ref)
    # the unfused graph: the same step on the plain versions (train-mode BN
    # renormalises every conv, so a current one ulp off spreads to every
    # later layer; reference+grad's cuDNN convs sum in another order)
    plain = TrainPath(torch, M, cfg, variables, tcfg, tvar, "unfused",
                      "fused_dense+grad", suffix=" (plain versions)")
    with plain_launchers():
        plain.run(batches[:1], build_mod)
    kernels = paths["unfused", "fused_dense+grad"]
    compare_training(kernels, plain)
    for path in (kernels, plain):
        rel_loss, errs, worst_spikes = training_distance(
            path, paths["unfused", "reference+grad"])
        say(f"[train] for information, {path.name} vs reference+grad step "
            f"1: loss rel diff {rel_loss:.3e}; gradient leaves past 1e-3: "
            f"{sum(e > 1e-3 for e in errs)} of {len(errs)}; worst spike "
            f"total rel diff {worst_spikes:.3e}")
    dense = paths["fold", "fused_dense+grad"]
    packed = paths["fold", "fused_packed+grad"]
    require(packed.losses == dense.losses,
            f"fused_packed+grad losses {packed.losses} != fused_dense+grad's "
            f"{dense.losses}")
    unequal = sum(not torch.equal(a, b)
                  for a, b in zip(packed.grads, dense.grads))
    require(unequal == 0, f"fused_packed+grad: {unequal} gradient leaves "
                          f"differ from fused_dense+grad's")
    say(f"[train] fused_packed+grad losses and step-1 gradients bit-equal to "
        f"fused_dense+grad's ({len(dense.grads)} leaves)")
    return paths


def phase_auto_training(torch, M, build_mod, dev, batch: int, beta: float,
                        names: list):
    """Three KD steps on the folded graph at the quiet regime under
    auto+grad (``observe_train_sparsity`` after each step) and under
    fused_dense+grad from the same weights. Prints the backward plans and
    the launches; holds auto+grad's step 1 to the training gates against
    fused_dense+grad with equal spike totals, bit-equal where every plan
    is fused. Returns both paths by name."""
    tuner = M.get_tuner()
    cfg, variables = init_model(torch, M.snn_cnn, dev, quiet_beta=beta)
    tcfg, tvar, batches = kd_setup(torch, M, dev, batch)
    paths = {}
    for policy in ("fused_dense+grad", "auto+grad"):
        path = TrainPath(torch, M, cfg, variables, tcfg, tvar, "fold",
                         policy, suffix=" quiet")
        tuner.reset()
        tuner.trace = []
        path.run(batches, build_mod, observe=policy == "auto+grad")
        trace, tuner.trace = tuner.trace, None
        if policy == "auto+grad":
            per = len(names)
            require(len(trace) == per * (1 + len(batches)),
                    f"auto+grad traced {len(trace)} plans")
            print_plans(names, trace[:per], f"{path.name} step 1")
            print_plans(names, trace[-per:], f"{path.name} step "
                        f"{len(batches)}")
            say(f"[auto] {path.name}: tuner hint after the steps "
                f"{tuner.snapshot()['observed_active_frac']}")
            path.trace = trace
        paths[path.name] = path
    dense = paths["train fold fused_dense+grad quiet"]
    auto = paths["train fold auto+grad quiet"]
    compare_training(auto, dense)
    require(auto.spikes == dense.spikes,
            f"{auto.name}: step-1 spike totals differ from {dense.name}")
    if all(p.kernels == "fused" for *_, p in auto.trace):
        require(auto.losses == dense.losses and all(
            torch.equal(a, b) for a, b in zip(auto.grads, dense.grads)),
            f"{auto.name}: every plan fused, but not bit-equal to "
            f"{dense.name}")
        say(f"[auto] {auto.name}: every plan fused; losses and step-1 "
            f"gradients bit-equal to {dense.name}")
    return paths


def training_distance(path, ref) -> tuple[float, list, float]:
    """Step 1 of ``path`` against ``ref``: (loss relative difference, each
    gradient leaf's relative L2 error, the worst spike total's relative
    difference); prints the three worst leaves."""
    rel_loss = abs(path.losses[0] - ref.losses[0]) / abs(ref.losses[0])
    errs = [float((a - b).norm()) / max(float(b.norm()), 1e-30)
            for a, b in zip(path.grads, ref.grads)]
    worst_spikes = max(abs(path.spikes[k] - b) / max(b, 1.0)
                       for k, b in ref.spikes.items())
    top = sorted(range(len(errs)), key=lambda i: -errs[i])[:3]
    say(f"[train] {path.name} vs {ref.name} step 1: worst gradient leaves "
        + ", ".join(f"#{i} {tuple(path.grads[i].shape)} {errs[i]:.3e}"
                    for i in top))
    return rel_loss, errs, worst_spikes


def compare_training(path, ref) -> None:
    """Step 1 of a kernel path against ``ref``: spike totals within 0.1 %,
    the loss within 1e-4 relative, each gradient leaf within a relative L2
    error of 1e-3."""
    rel_loss, errs, worst_spikes = training_distance(path, ref)
    worst = max(range(len(errs)), key=lambda i: errs[i])
    say(f"[train] {path.name} vs {ref.name} step 1: loss rel diff "
        f"{rel_loss:.3e} (gate 1e-4); worst gradient leaf #{worst} "
        f"{tuple(path.grads[worst].shape)}: relative L2 error "
        f"{errs[worst]:.3e} (gate 1e-3); worst spike total rel diff "
        f"{worst_spikes:.3e} (gate 1e-3)")
    require(worst_spikes <= 1e-3, f"{path.name}: step-1 spike totals differ "
                                  f"by {worst_spikes}")
    require(rel_loss <= 1e-4, f"{path.name}: step-1 loss {path.losses[0]} "
                              f"vs {ref.losses[0]}")
    require(errs[worst] <= 1e-3, f"{path.name}: gradient leaf #{worst} "
                                 f"relative L2 error {errs[worst]} past 1e-3")


# ---------------------------------------------------------------- phase 5b
def time_forwards(torch, snn_cnn, fused, images, cfg, policy: str,
                  iters: int) -> list:
    """Host ms of ``iters`` synchronised forwards, after two warm-ups."""
    times = []
    for i in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snn_cnn.forward(fused, images, cfg, policy=policy)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_timesteps(torch, M, build_mod, dev, images, batch: int) -> dict:
    """The paper's T = 4 baseline on the card: the phase-4 QKFResNet-11
    (same weights, every BN beta 0.5, folded) at ``timesteps=4``, the input
    repeated over the steps. Forward under fused_dense and fused_packed
    (launch counts reset just before and read just after each) against
    reference: spike totals within 0.1 %, top-1 >= 99 %, packed spike
    totals equal to dense; median forwards at T = 4 beside T = 1 on the
    same weights and images; the device breakdown of a fused_dense and a
    fused_packed forward. Then three folded KD steps per training path
    from one state, step 1 of each kernel path held to the training gates
    against reference+grad, packed losses and gradients bit-equal to dense, every
    step's launches asserted, and the median step with its split and peak
    memory. Returns the kernel paths by name, for the kernels line."""
    snn_cnn = M.snn_cnn
    cfg1, variables = init_model(torch, snn_cnn, dev)
    cfg = dataclasses.replace(cfg1, timesteps=T_STEPS)
    fused = snn_cnn.fuse_model(variables, cfg)
    say(f"[T] QKFResNet-11 width 1.0 at T = {T_STEPS}, batch {batch}: the "
        f"phase-4 weights, images repeated over the steps")
    paths, auxes = {}, {}
    for policy in ("fused_dense", "fused_packed"):
        build_mod.reset_launches()
        with build_mod.capture_launches() as captured:
            logits, _, aux = snn_cnn.forward(fused, images, cfg,
                                             policy=policy)
            torch.cuda.synchronize()
        launches = dict(build_mod.LAUNCHES)
        say(f"[T] kernel launches in one {policy} T={T_STEPS} forward: "
            f"{launches}")
        require(launches == EXPECTED_LAUNCHES_T[policy],
                f"{policy} T={T_STEPS} launch counts {launches} != "
                f"{EXPECTED_LAUNCHES_T[policy]}")
        require(all(a[14] is not None for n_, a, *_ in captured
                    if n_ == "fused_pe"),
                f"a {policy} T={T_STEPS} fused PE launch ran without state")
        paths[T_FORWARD[policy]] = (logits, aux, launches, captured)
        auxes[policy] = (logits, aux)
    ref_logits, _, ref_aux = snn_cnn.forward(fused, images, cfg,
                                             policy="reference")
    torch.cuda.synchronize()
    (d_logits, d_aux), (p_logits, p_aux) = (auxes["fused_dense"],
                                            auxes["fused_packed"])
    for key, rate in d_aux["rates"].items():
        say(f"[T] rate {key}: fused_dense {float(rate):.4f} fused_packed "
            f"{float(p_aux['rates'][key]):.4f} reference "
            f"{float(ref_aux['rates'][key]):.4f}")
        require(0.0 < float(rate) < 1.0, f"T={T_STEPS} rate {key} = "
                                         f"{float(rate)}")
    compare_spikes(d_aux, ref_aux, f"T={T_STEPS} fused_dense vs reference",
                   1e-3)
    compare_spikes(p_aux, d_aux, f"T={T_STEPS} fused_packed vs fused_dense",
                   0.0)
    check_logits(torch, d_logits, ref_logits, batch,
                 f"T={T_STEPS} fused_dense vs reference")
    check_logits(torch, p_logits, ref_logits, batch,
                 f"T={T_STEPS} fused_packed vs reference")
    say(f"[T] spike bytes between kernels at T={T_STEPS}: fused_dense "
        f"{d_aux['spike_hbm_bytes']}, fused_packed "
        f"{p_aux['spike_hbm_packed_bytes']} (int8 equivalent "
        f"{p_aux['spike_hbm_dense_bytes']})")
    card = gpu_name_and_power()
    medians = {}
    fused1 = snn_cnn.fuse_model(variables, cfg1)
    for policy in ("fused_dense", "fused_packed", "reference"):
        for t_, c_, f_ in ((1, cfg1, fused1), (T_STEPS, cfg, fused)):
            times = time_forwards(torch, snn_cnn, f_, images, c_, policy,
                                  ITERS)
            medians[policy, t_] = statistics.median(times)
        m1, mt = medians[policy, 1], medians[policy, T_STEPS]
        say(f"[timing] forward {policy} T=1 vs T={T_STEPS} ({card}): median "
            f"{m1:.3f} vs {mt:.3f} ms over {ITERS}, {batch / m1 * 1e3:.1f} vs "
            f"{batch / mt * 1e3:.1f} images/s; T={T_STEPS} / T=1 "
            f"{mt / m1:.3f}")
    for policy in ("fused_dense", "fused_packed"):
        phase_profile(torch, snn_cnn, cfg, fused, images, policy,
                      medians[policy, T_STEPS], tag=f"{policy} T={T_STEPS}")

    tcfg, tvar, batches = kd_setup(torch, M, dev, batch)
    tpaths = {}
    for policy in ("reference+grad", "fused_dense+grad", "fused_packed+grad"):
        path = TrainPath(torch, M, cfg, variables, tcfg, tvar, "fold", policy,
                         suffix=f" T={T_STEPS}")
        path.run(batches, build_mod)
        want = (dict.fromkeys(FOLD_STEP_LAUNCHES_T, 0)
                if policy.startswith("reference")
                else dict(FOLD_STEP_LAUNCHES_T, unpack_spikes=52)
                if policy.startswith("fused_packed")
                else FOLD_STEP_LAUNCHES_T)
        for i, got in enumerate(path.launches):
            require(got == want, f"{path.name} step {i}: launches {got} != "
                                 f"{want}")
        for loss in path.losses:
            require(math.isfinite(loss), f"{path.name}: loss {loss}")
        tpaths["fold", policy] = path
    ref = tpaths["fold", "reference+grad"]
    for policy in ("fused_dense+grad", "fused_packed+grad"):
        compare_training(tpaths["fold", policy], ref)
    dense = tpaths["fold", "fused_dense+grad"]
    packed = tpaths["fold", "fused_packed+grad"]
    require(packed.losses == dense.losses,
            f"T={T_STEPS} fused_packed+grad losses {packed.losses} != "
            f"fused_dense+grad's {dense.losses}")
    unequal = sum(not torch.equal(a, b)
                  for a, b in zip(packed.grads, dense.grads))
    require(unequal == 0, f"T={T_STEPS} fused_packed+grad: {unequal} "
                          f"gradient leaves differ from fused_dense+grad's")
    say(f"[T] fused_packed+grad losses and step-1 gradients bit-equal to "
        f"fused_dense+grad's at T={T_STEPS} ({len(dense.grads)} leaves)")
    graph = f"fold T={T_STEPS}"
    step_ms = time_training(torch, M, {(graph, p.policy): p
                                       for p in tpaths.values()},
                            batch, TRAIN_ITERS, profile=False)
    profile_step(torch, dense, step_ms[graph, "fused_dense+grad"])
    for path in (dense, packed):
        paths[path.name] = (None, None, path.launches[0], path.captured)
    return paths


def phase_packed_dw(torch, K, build_mod, captured) -> tuple:
    """dw over a packed x (packed_in): every dw launch of the folded
    fused_packed+grad step (T = 1), its int8 x packed by the pack kernel,
    launched through ``spike_matmul_dw`` with the dense skip and with the
    gated walk; each bit-equal to the int8 dense-skip launch on the same
    spikes. Returns the path tuple of these launches."""
    picks = [(K.pack_spikes(a[0]), a) for n_, a, *_ in captured
             if n_ == "spike_matmul_dw"]
    require(len(picks) == 16, f"{len(picks)} dw launches to replay")
    build_mod.reset_launches()
    with build_mod.capture_launches() as out:
        for ps, (x8, g, vld) in picks:
            want = K.spike_matmul_dw_cuda(x8, g, vld)
            for skip in ("dense", "gated"):
                got = K.spike_matmul_dw(ps, g, skip=skip)
                require(torch.equal(got, want),
                        f"packed dw {skip} [{x8.shape[0]}x{x8.shape[1]}] is "
                        f"not the int8 launch's bits")
        torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    say(f"[packed dw] {len(picks)} dw launches of the packed step replayed "
        f"on packed x, dense and gated, bit-equal to the int8 launches; "
        f"launches {launches}")
    require(launches["spike_matmul_dw"] == 16
            and launches["spike_matmul_dw_gated"] == 16,
            f"packed dw launches {launches}")
    return None, None, launches, out


def time_training(torch, M, paths, batch: int, iters: int,
                  profile: bool = True) -> dict:
    """Median step time of each training path (host clock around a
    synchronised step), its forward (the student alone, no autograd) and
    the rest (backward and update), images/s and peak memory; then the
    profiler's device breakdown of one fused_dense+grad step on the folded
    graph."""
    medians = {}
    for (graph, policy), path in paths.items():
        carry, data = path.carry, path.batch0
        step_ms, fwd_ms = [], []
        for i in range(iters + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, _ = path.step(carry, data)
            torch.cuda.synchronize()
            if i:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        pol = M.as_policy(policy).for_training()
        with torch.no_grad():
            for i in range(iters + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path.student(carry[0], carry[2], data["images"], policy=pol)
                torch.cuda.synchronize()
                if i:
                    fwd_ms.append((time.perf_counter() - t0) * 1e3)
        med, fwd = statistics.median(step_ms), statistics.median(fwd_ms)
        medians[graph, policy] = med
        say(f"[timing] train {graph} {policy}: step median {med:.3f} ms over "
            f"{iters} (min {min(step_ms):.3f}, max {max(step_ms):.3f}); "
            f"{batch / med * 1e3:.1f} images/s; forward {fwd:.3f} ms, "
            f"backward and update {max(med - fwd, 0.0):.3f} ms; peak memory "
            f"{max(path.peak) / 2**30:.3f} GiB")
    if profile:
        path = paths["fold", "fused_dense+grad"]
        profile_step(torch, path, medians["fold", "fused_dense+grad"])
    return medians


def profile_step(torch, path, step_ms: float, reps: int = 2) -> None:
    """``torch.profiler`` self device time by kernel over ``reps`` steps,
    and the device's idle share of the step's median time."""
    carry, data = path.carry, path.batch0
    carry, _ = path.step(carry, data)
    torch.cuda.synchronize()

    def step():
        nonlocal carry
        carry, _ = path.step(carry, data)
    rows = device_rows(torch, step, reps)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        say(f"[profile] the profiler reported no device time: {path.name} "
            f"device breakdown not measured")
        return
    say(f"[profile] {path.name}: device busy {busy:.3f} ms per step of "
        f"median {step_ms:.3f} ms: idle share "
        f"{max(0.0, 1 - busy / step_ms):.3f}")
    for ms, count, key in rows[:20]:
        say(f"[profile]   {path.name} {ms:8.4f} ms  x{count:<4d} {key[:100]}")


def time_cuda(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_FILLER = []
# bytes read between two timed calls to evict the H100's 50 MB L2, so that
# each call reads its operands from device memory, as the main path's
# launches do (a decode tick streams 84 distinct weights, 1.4 GB); a read
# leaves clean lines, so the timed call pays no write-back of the flush
L2_FLUSH_BYTES = 256 << 20


def device_time(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call over ``reps`` calls with a cold L2, after
    warm-up: before each call a 256 MB buffer is summed (evicting the
    call's operands from the L2), and a pair of CUDA events brackets the
    call alone. 4096^3 f32 matmuls (about 2.7 ms each on the card), as many
    as the last warm-up call's host time asks for (at most 16), are queued
    first, so that the calls are enqueued while they run and each call's
    events then bracket its device work: a call whose host work outlasts
    its kernels (a wrapper's checks, allocations and ctypes call) is timed
    by its device work, as ``time_cuda`` would not. (The flush also ends
    programmatic overlap between two calls, which a tick's launches may
    have.)"""
    if not _FILLER:
        gen = torch.Generator(device="cuda").manual_seed(5)
        _FILLER.extend(torch.randn((4096, 4096), generator=gen, device="cuda")
                       for _ in range(2))
        _FILLER.append(torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                  device="cuda"))
    a, b, flush = _FILLER
    for _ in range(warmup):
        host = time.perf_counter()      # the last warm-up call's host time
        flush.sum()
        fn()
        host = time.perf_counter() - host
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for _ in range(min(16, 1 + math.ceil(1.5 * reps * host / 2.7e-3))):
        torch.matmul(a, b)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def tile_args(K, name: str, args, route: str = "decode") -> tuple:
    """A launch's operands padded to whole 128-row blocks: a fused PE
    launch's (``fused_pe_tile_operands``: a float x's, read at its own rows
    on either route, and its all-ones vld map) and a decode-route spike
    matmul launch's (``spike_matmul_tile_operands``), any other as it is.
    The plain versions, the bounds and the checks read these; the tile
    route computes the same outputs on them."""
    if name == "fused_pe":
        return K.fused_pe_tile_operands(args)
    if name == "spike_matmul" and route == "decode":
        return K.spike_matmul_tile_operands(args)
    return args


def relaunch(launch_fn: dict, launch):
    """A captured launch again, on its own operands and route."""
    fn = launch_fn[launch.name]
    if launch.route != "tile":
        return lambda: fn(*launch.args, route=launch.route)
    return lambda: fn(*launch.args)


def valid_extent(torch, n: int, blocks: int, width: int = 128):
    """How many of each ``width``-wide block's indices lie below ``n``."""
    starts = torch.arange(blocks, dtype=torch.float64) * width
    return (n - starts).clamp(0, width)


def spike_bytes(K, t) -> float:
    """Bytes of a binary spike operand at the caller's extent: one per
    spike as int8 (whatever dtype it reached the wrapper in: the forward
    produces every spike map as int8 and widens some only for the call),
    1/8 when packed (4 bytes a word)."""
    if isinstance(t, K.PackedSpikes):
        return math.prod(t.shape) / 8.0
    return float(t.numel())


def bound(torch, K, name: str, args, inputs) -> tuple[float, float, float]:
    """(bytes, operations, block operations) of one launch, from the
    kernel's operands ``args`` and the tensors its caller gave the wrapper
    (``inputs``, before padding and casts). A fused PE launch's ``inputs``
    may end with the number of weight columns its product needs, where
    that is fewer than the weight holds: a grouped wk's columns are
    repeated once per query head before the launch (``grouped_kv``).

    Bytes: each input read once and each output written once, at the
    caller's extent (never the 128-padded one); spike maps as
    ``spike_bytes`` counts them. A matmul reads only the x blocks its vld
    map does not skip, and the w rows some row block uses. Operations: what
    the data needs; a spike matmul needs one multiply-add per nonzero
    spike and valid output column (2 * nnz(x) * N). Block operations: the
    dense product over the blocks the kernel does not skip, which is the
    work the kernel's algorithm does (2 * 128 * 128 * Np per active
    block)."""
    if name == "lif_update":
        cur, v_prev, s_prev = inputs
        n = cur.numel()
        # current and v_prev f32, s_prev spikes; spikes int8 and v_next f32
        return 4.0 * n + 4.0 * n + n + n + 4.0 * n, 7.0 * n, 7.0 * n
    if name == "w2ttfs_pool":
        spikes, fc_w, fc_b = inputs
        b, classes = spikes.shape[0], fc_w.shape[1]
        ops = spikes.numel() + 2.0 * b * fc_w.numel()
        return (spikes.numel() + 4.0 * (fc_w.numel() + fc_b.numel()
                                        + b * classes), ops, ops)
    if name == "pack_spikes":
        (x,) = inputs
        n = float(x.numel())
        tiles = args[0].shape[0] * math.prod(
            -(-d // 128) for d in x.shape[-2:])
        # x read; words, vld_cnt and occ written; a compare per position
        return n + n / 8.0 + 8.0 * tiles, n, n
    if name == "unpack_spikes":
        # the words of the extent read (ceil(k / 32) a row, none of the
        # padding), the map written in the launch's dtype; an operation a
        # spike
        words, m, k, dtype = args
        rows = math.prod(words.shape[:-2]) * m
        n = float(rows * k)
        return 4.0 * rows * -(-k // 32) + n * dtype.itemsize, n, n
    if name == "spike_matmul_dx":
        g, w, v = args[:3]
        (m, n), k = g.shape, w.shape[0]
        # g (and v) read, w read, dx (and dv) written; the product is
        # dense in g: 2 * M * N * K operations (the surrogate adds a few an
        # element of g); the kernel computes over its planned tiles of dx
        nbytes = 4.0 * (m * n + k * n + m * k) + (8.0 * m * n if v is not None
                                                  else 0.0)
        ops = 2.0 * m * n * k + (6.0 * m * n if v is not None else 0.0)
        plan = K.dx_plan(m, n, k)
        tiles = plan.mtiles * 128 * plan.ktiles * plan.block_k
        return nbytes, ops, 2.0 * tiles * n + ops - 2.0 * m * n * k
    if name == "spike_matmul_dw_gated":
        x, g, _ = args
        vld = x.vld_cnt if isinstance(x, K.PackedSpikes) else K.vld_map(x)
        return bound(torch, K, "spike_matmul_dw", (x, g, vld), inputs)
    if name == "spike_matmul_gated":
        xp, wp, gate, packed = args
        walked = K.gated_mask(gate.nact, gate.kmap, None,
                              gate.kmap.shape)
        return bound(torch, K, "spike_matmul", (xp, wp, walked.to(
            torch.int32), packed), inputs)
    if name == "spike_matmul_dw":
        xa, g, vld = args
        x = dense_x(K, xa)
        (m, k), n = x.shape, g.shape[1]
        # a bound's active blocks, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
        active = (vld > 0).to(torch.float64).cpu()
        rows = valid_extent(torch, m, active.shape[0])
        cols = valid_extent(torch, k, active.shape[1])
        # the x blocks the skip keeps (one byte a spike position), the g
        # rows some kept block needs, dw written; 2 * nnz(x) * N operations
        x_bytes = float((active * rows[:, None] * cols[None, :]).sum())
        if x is not xa:                # packed: a bit a spike position
            x_bytes /= 8.0
        g_rows = float((rows * (active.sum(dim=1) > 0)).sum())
        nbytes = x_bytes + 4.0 * g_rows * n + 4.0 * k * n + 4.0 * vld.numel()
        nnz = int((x != 0).sum())
        block_ops = 2.0 * float(active.sum()) * 128 * 128 * (-(-n // 64) * 64)
        return nbytes, 2.0 * nnz * n, block_ops
    if name == "flash_attention":
        return flash_bound(*args[:4])
    if name == "qk_attention":
        q, k, _ = args
        n = float(q.numel())
        # q and k read, the masked k written; an add per q element and a
        # multiply per output element
        return 3.0 * n * q.element_size(), 2.0 * n, 2.0 * n
    xp, wp, vld = args[:3]
    x, w = inputs[:2]
    packed_x = isinstance(x, K.PackedSpikes)
    (m0, k0), n0 = x.shape, w.shape[1]
    # the product needs only the kv heads' columns of a grouped wk; the
    # spikes it writes (and masks) span every query head
    n_prod = inputs[5] if len(inputs) > 5 else n0
    np_ = wp.shape[1]
    nnz = int(K.popcount32(xp).sum()) if packed_x else int((xp != 0).sum())
    if xp.is_floating_point():   # a dense activation: the full product
        nnz = m0 * k0
    # a bound's active blocks, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
    active = (vld > 0).to(torch.float64).cpu()
    bk = K.block_width(wp.shape[0], active.shape[1])   # 128, or 256
    rows = valid_extent(torch, m0, active.shape[0])
    cols = valid_extent(torch, k0, active.shape[1], bk)
    x_bytes = float((active * rows[:, None] * cols[None, :]).sum())
    if packed_x:
        x_bytes /= 8.0
    elif xp.is_floating_point():
        x_bytes *= xp.element_size()
    w_rows = float((cols * (active.sum(dim=0) > 0)).sum())
    nbytes = x_bytes + 4.0 * w_rows * n_prod + 4.0 * vld.numel()
    block_ops = 2.0 * float(active.sum()) * 128 * bk * np_
    if name == "spike_matmul":
        # the tile's work: each kept block's 32-deep steps below K, over
        # its planned tiles' columns
        kw = wp.shape[0]
        plan = K.tile_plan(xp.shape[0], wp.shape[1], kw)
        depth = torch.ceil((kw - torch.arange(active.shape[1],
                                              dtype=torch.float64) * bk)
                           .clamp(0, bk) / 32) * 32
        block_ops = (2.0 * 128 * float((active * depth[None, :]).sum())
                     * plan.ntiles * plan.block_n)
        return nbytes + 4.0 * m0 * n0, 2.0 * nnz * n0, block_ops
    bias, residual, q = inputs[2:5]
    packing = args[10]
    tiles_out = -(-m0 // 128) * -(-n0 // args[11])     # vld_next entries
    nbytes += m0 * n0 / (8.0 if packing.out else 1.0) + 4.0 * tiles_out
    if bias is not None:
        nbytes += 4.0 * n_prod
    if residual is not None:                       # f32 current or spikes
        nbytes += (4.0 * residual.numel()
                   if isinstance(residual, torch.Tensor)
                   and residual.is_floating_point()
                   else spike_bytes(K, residual))
    if q is not None:
        nbytes += spike_bytes(K, q)
    if packing.current:                            # the f32 current out
        nbytes += 4.0 * m0 * n0
    epilogue = 3.0 * m0 * n0
    if args[14] is not None:     # LIF state: v_prev f32, s_prev int8 read,
        nbytes += 9.0 * m0 * n0  # v_next f32 written; decay, add, reset
        epilogue += 6.0 * m0 * n0
    return nbytes, 2.0 * nnz * n_prod + epilogue, block_ops + epilogue


def flash_bound(q, k, v, causal) -> tuple[float, float, float]:
    """(bytes, operations, operations) of one K9 call: q, k, v read and
    out written once at their dtype (K and V at their Hkv heads); 2 D
    operations (a multiply and an add) a (query, key) pair for the scores
    and again for PV, over the S (S + 1) / 2 causal pairs (about half of
    S^2) or all S^2."""
    b, s, h, d = q.shape
    nbytes = float(2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    pairs = s * (s + 1) / 2 if causal else float(s * s)
    ops = 4.0 * b * h * d * pairs
    return nbytes, ops, ops


# the kernels whose products run on the tensor cores as three bf16 terms
# of an exact split (``ops_ms``)
DW_KERNELS = ("spike_matmul_dw", "spike_matmul_dw_gated")


def spike_tile(name: str, args) -> bool:
    """A fused PE launch of a spike x (int8 or packed words), which takes
    the tensor-core tile (csrc/event_wgmma.cuh)."""
    return name in ("fused_pe", "fused_pe_gated") and \
        not args[0].is_floating_point()


def ops_ms(name: str, args, ops: float) -> float:
    """The least time, in ms, of a launch's ``ops`` operations at the
    card's peak for their types: K9's as ``flash_ops_ms``; dw's products
    of 0/1 spikes and f32 g keep g exact on the tensor cores only as three
    products, one a term of g's split into three bf16 values, so 3 x
    ``ops`` at the bf16 tensor-core rate; a spike-x fused PE's product the
    same with w split (``bound`` counts it as 2 nnz(x) N), and its
    epilogue's operations (``bound``'s 3 or, with the LIF state, 9 an
    output element) at the f32 rate; every other kernel's at the f32 rate
    outside the tensor cores (IEEE f32, which parity needs)."""
    if name == "flash_attention":
        return flash_ops_ms(args[0], ops)
    if name in DW_KERNELS:
        return 3 * ops / PEAK_BF16_TC_OPS_PER_S * 1e3
    if spike_tile(name, args):
        epilogue = (9.0 if args[14] is not None else 3.0) * args[6] * args[7]
        return (3 * (ops - epilogue) / PEAK_BF16_TC_OPS_PER_S
                + epilogue / PEAK_F32_OPS_PER_S) * 1e3
    return ops / PEAK_F32_OPS_PER_S * 1e3


def flash_ops_ms(q, ops: float) -> float:
    """The least time, in ms, of K9's ``ops`` operations at the card's peak
    for their types: half are QK^T, half PV. With bf16 q, k and v, QK^T runs
    once at the bf16 tensor-core rate (a product of two bf16 values is
    exact in f32, and the tensor cores sum in f32); PV's weights p are f32,
    not bf16, and the least tensor-core work that keeps them exact is three
    products, one a term of p's split into three bf16 values (24
    significand bits in three 8-bit pieces): 2 x ``ops`` at the bf16
    tensor-core rate in all. An f32 call runs at the f32 rate outside the
    tensor cores."""
    if q.element_size() == 2:
        return 2 * ops / PEAK_BF16_TC_OPS_PER_S * 1e3
    return ops / PEAK_F32_OPS_PER_S * 1e3


def device_rows(torch, fn, reps: int) -> list:
    """``torch.profiler`` over ``reps`` calls of ``fn``, synchronised: each
    device kernel's self time a call, as (ms, launches a call, name),
    largest first (kernels only: the aten ops would count twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / reps, ev.count // reps, ev.key))
    rows.sort(reverse=True)
    return rows


def phase_profile(torch, snn_cnn, cfg, fused, images, policy: str,
                  forward_ms: float, reps: int = 3, tag: str = "") -> None:
    """Where the time of one forward of a kernel path goes on the device:
    ``torch.profiler`` self device time by kernel, summed over ``reps``
    forwards, and the device's idle share of the forward's median time
    (printed under ``tag``, the policy by default)."""
    tag = tag or policy
    snn_cnn.forward(fused, images, cfg, policy=policy)
    torch.cuda.synchronize()
    rows = device_rows(torch, lambda: snn_cnn.forward(fused, images, cfg,
                                                      policy=policy), reps)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        say(f"[profile] the profiler reported no device time: {tag} "
            f"device breakdown not measured")
        return
    say(f"[profile] {tag}: device busy {busy:.3f} ms per forward of "
        f"median {forward_ms:.3f} ms: idle share "
        f"{max(0.0, 1 - busy / forward_ms):.3f}")
    for ms, count, key in rows[:20]:
        say(f"[profile]   {tag} {ms:8.4f} ms  x{count:<4d} {key[:100]}")


def library_call(torch, K, name: str, args, inputs):
    """One PyTorch call computing the launch's product on the same data,
    or None: torch.matmul of the caller's x (int8 cast to f32, a packed x
    unpacked to its logical f32 map) by w; for dx, dv @ wᵀ (dv as the
    plain version forms it); for dw, xᵀ @ g with x cast to f32; for a fused
    PE launch (with or without the emitted current) its product. No single
    call packs or unpacks, or masks QK rows."""
    if name == "spike_matmul_dx":
        g, w, v, surrogate, alpha, v_th = args
        _, dv = K.spike_matmul_dx_ref(g, w, v, surrogate=surrogate,
                                      alpha=alpha, v_th=v_th)
        return lambda: torch.matmul(dv, w.T)
    if name == "flash_attention":
        return sdpa_call(torch, *args[:4])
    if name in ("spike_matmul_dw", "spike_matmul_dw_gated"):
        x, g, _ = args
        xf = dense_x(K, x).to(torch.float32)
        return lambda: torch.matmul(xf.T, g)
    if name not in ("fused_pe", "spike_matmul", "fused_pe_gated",
                    "spike_matmul_gated"):
        return None
    x, w = inputs[:2]
    # (a dense activation x: torch.matmul(x.float(), w) on the same data)
    xf = (K.unpack_spikes_ref(x, torch.float32)
          if isinstance(x, K.PackedSpikes) else x.to(torch.float32))
    return lambda: torch.matmul(xf, w)


def sdpa_call(torch, q, k, v, causal):
    """``scaled_dot_product_attention`` on the same operands ([B, H, S, D]
    views made once, grouped KV through ``enable_gqa``): the library's
    yardstick, never called by the port."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=kt.shape[1] != qt.shape[1])


def sdpa_backend(torch, q, k, v, causal) -> str:
    """The backend SDPA picks for these operands (PyTorch's own choice,
    ``torch._fused_sdp_choice``), and a device kernel it launched, read
    off the profiler where it saw one."""
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = kt.shape[1] != qt.shape[1]
    choice = SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, None, 0.0, causal, scale=None, enable_gqa=gqa)).name
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sdpa_call(torch, q, k, v, causal)()
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA]
    kernel = max(names, key=len, default="none seen by the profiler")
    return f"{choice} (kernel {kernel[:60]})"


def dense_twin(torch, K, name: str, args):
    """The dense-skip launch of a gated launch's operands (the same x,
    weights and vld map), or None for another kernel."""
    if name == "fused_pe_gated":
        return lambda: K.fused_pe_cuda(*args[:12], None, *args[13:])
    if name == "spike_matmul_gated":
        xp, wp, gate, packed = args
        vld = K.gated_mask(gate.nact, gate.kmap, None,
                           gate.kmap.shape).to(torch.int32)
        return lambda: K.spike_matmul_cuda(xp, wp, vld, packed)
    if name == "spike_matmul_dw_gated":
        x, g, _ = args
        vld = x.vld_cnt if isinstance(x, K.PackedSpikes) else K.vld_map(x)
        return lambda: K.spike_matmul_dw_cuda(x, g, vld)
    return None


def phase_timing(torch, K, snn_cnn, models, images, paths, parity: Parity,
                 iters: int, tuner) -> list[dict]:
    batch = images.shape[0]
    medians = {}
    for regime, (beta, cfg, fused) in models.items():
        for policy in ("fused_dense", "fused_packed", "reference",
                       *AUTO_POLICIES):
            times = time_forwards(torch, snn_cnn, fused, images, cfg, policy,
                                  iters)
            med = medians[policy, regime] = statistics.median(times)
            say(f"[timing] forward {policy} {regime} (resblock BN1 beta "
                f"{0.5 if beta is None else beta}): "
                f"median {med:.3f} ms over {iters} (min {min(times):.3f}, "
                f"max {max(times):.3f}); {batch / med * 1e3:.1f} images/s")
        for policy in AUTO_POLICIES:
            tuner.read_s, tuner.reads = 0.0, 0
            torch.cuda.synchronize()
            snn_cnn.forward(fused, images, cfg, policy=policy)
            torch.cuda.synchronize()
            say(f"[timing] tuner metadata reads in one {policy} {regime} "
                f"forward: {tuner.reads} device-to-host reads, "
                f"{tuner.read_s * 1e3:.3f} ms on the host")
    _, cfg, fused = models["busy"]
    for policy in ("fused_dense", "fused_packed"):
        phase_profile(torch, snn_cnn, cfg, fused, images, policy,
                      medians[policy, "busy"])

    launch_fn = {"lif_update": K.lif_update_cuda,
                 "fused_pe": K.fused_pe_cuda,
                 "fused_pe_gated": K.fused_pe_cuda,
                 "spike_matmul": K.spike_matmul_cuda,
                 "spike_matmul_gated": K.spike_matmul_gated_cuda,
                 "spike_matmul_dw_gated": K.spike_matmul_dw_gated_cuda,
                 "w2ttfs_pool": K.w2ttfs_pool_cuda,
                 "pack_spikes": K.pack_spikes_cuda,
                 "unpack_spikes": K.unpack_spikes_cuda,
                 "spike_matmul_dx": K.spike_matmul_dx_cuda,
                 "spike_matmul_dw": K.spike_matmul_dw_cuda,
                 "qk_attention": K.qk_attention_cuda,
                 "flash_attention": K.flash_attention_cuda}
    plain_fn = {"lif_update": K.lif_update_ref,
                "fused_pe": K.fused_pe_block_ref,
                "fused_pe_gated": K.fused_pe_block_ref,
                "spike_matmul": K.spike_matmul_block_ref,
                "spike_matmul_gated": K.spike_matmul_gated_block_ref,
                "spike_matmul_dw_gated": K.spike_matmul_dw_gated_ref,
                "w2ttfs_pool": K.w2ttfs_pool_fc_ref,
                "pack_spikes": lambda x: K.pack_spikes_ref(x, with_occ=True),
                "unpack_spikes": lambda w, m, k, dt: K.unpack_words(
                    w, dt)[..., :m, :k],
                "spike_matmul_dx": lambda g, w, v, s_, a, t: (
                    K.spike_matmul_dx_ref(g, w, v, surrogate=s_, alpha=a,
                                          v_th=t)),
                "spike_matmul_dw": K.spike_matmul_dw_ref,
                "qk_attention": lambda q, k, t: K.qk_attention_ref(
                    q, k, threshold=t),
                "flash_attention": lambda q, k, v, c: K.attention_ref(
                    q, k, v, causal=c)}
    card = gpu_name_and_power()
    floor = device_time(torch, K.launch_empty, reps=50)
    say(f"[timing] launch floor ({card}): {floor:.4f} ms, one launch of an "
        f"empty kernel timed as the rows are (device_time); a row whose "
        f"bound lies under its launches times this reads against it")
    rows_map = {}
    for row, (kernel, policy, source, replaces) in ROWS.items():
        if policy is None:        # a gated route: the first path that ran it
            policy = next((p for p in GATED_PATHS if p in paths
                           and paths[p][2][kernel] > 0), None)
            require(policy is not None, f"{kernel} launched on no path")
        rows_map[row] = (kernel, policy, source, replaces)
    totals = {row: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": None, "bytes_s": 0.0, "ops_s": 0.0,
                    "block_ms": 0.0, "twin_ms": 0.0}
              for row in ROWS}
    row_of = {(kernel, policy): row
              for row, (kernel, policy, _, _) in rows_map.items()}
    routes = {row: set() for row in ROWS}
    tot_host = {row: {"ms": 0.0, "lib": 0.0, "tile": 0.0}
                for row in TILE_MS_BEFORE}
    # the float-x tile's launches of the LM step, per projection: (device
    # ms, torch.matmul ms) a launch
    lm_train_pe = {"wq": [], "wk": []}
    i = 0
    for policy, (_, _, _, captured) in paths.items():
        for launch in captured:
            name, args, inputs, route = launch
            row = row_of.get((name, policy))
            if row is None:     # the same kernel at the same shapes as the
                continue        # other path's launch, which is timed there
            # the main path's own operands: kernel vs plain version again
            CHECKS[name](torch, K, args, parity, f"main-path launch {i}",
                         **({} if route == "tile" else {"route": route}),
                         **({"path": policy} if CHECKS[name] is check_fused_pe
                            else {"row": row}
                            if CHECKS[name] in (check_spike_matmul, check_dx,
                                                check_dw, check_unpack)
                            else {}))
            targs = tile_args(K, name, args, route)
            ms = device_time(torch, relaunch(launch_fn, launch), reps=20)
            plain_ms = device_time(torch, lambda: plain_fn[name](*targs),
                                   reps=5)
            nbytes, ops, block_ops = bound(torch, K, name, targs, inputs)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = ops_ms(name, args, ops)
            t_block = ops_ms(name, args, block_ops)
            lib = library_call(torch, K, name, args, inputs)
            lib_ms = None if lib is None else device_time(torch, lib, reps=10)
            lib_name = "SDPA" if name == "flash_attention" else "torch.matmul"
            if row in TILE_MS_BEFORE:
                # the redesigned rows: the tile route on the same operands,
                # and the host clock, by which the tile's time was recorded
                host = tot_host[row]
                host["tile"] += device_time(
                    torch, lambda: launch_fn[name](*targs), reps=20)
                host["ms"] += time_cuda(torch, relaunch(launch_fn, launch),
                                        reps=20)
                host["lib"] += time_cuda(torch, lib, reps=10)
            del lib
            twin = dense_twin(torch, K, name, args)
            twin_ms = None if twin is None else device_time(torch, twin,
                                                            reps=20)
            if twin_ms is not None:
                totals[row]["twin_ms"] += twin_ms
            tot = totals[row]
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += max(t_bytes, t_ops)
            tot["bytes_s"] += t_bytes
            tot["ops_s"] += t_ops
            tot["block_ms"] += t_block
            if lib_ms is not None:
                tot["library_ms"] = (tot["library_ms"] or 0.0) + lib_ms
            shape = "x".join(str(d) for d in args[0].shape)
            if name in ("fused_pe", "spike_matmul", "spike_matmul_dx",
                        "spike_matmul_dw", "fused_pe_gated",
                        "spike_matmul_gated", "spike_matmul_dw_gated"):
                shape += f" @ {args[1].shape[0]}x{args[1].shape[1]}"
            if name in ("spike_matmul", "spike_matmul_gated") and \
                    route == "tile":
                plan = K.tile_plan(args[0].shape[0], args[1].shape[1],
                                   args[1].shape[0])
                shape += (f"; tile 128x{plan.block_n}, "
                          f"{plan.mtiles * plan.ntiles} tiles")
            if name == "fused_pe" and route == "tile" and \
                    args[0].is_floating_point():
                plan = K.float_tile_plan(args[6], args[1].shape[1],
                                         args[1].shape[0])
                shape += (f"; tile {plan.block_m}x{plan.block_n}, "
                          f"{plan.mtiles * plan.ntiles} tiles, {plan.ctas} "
                          f"CTAs, {K.FLOAT_TILE_RESIDENT} an SM")
            if row == "fused_pe_lm_train":
                lm_train_pe["wq" if inputs[4] is None else "wk"].append(
                    (ms, lib_ms))
            routes[row].add(route)
            say(f"[timing] launch {i} {row} [{shape}]"
                + (f" ({route} route)" if name in ("fused_pe", "spike_matmul",
                                                   "flash_attention")
                   else "") + ": "
                f"{ms:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}), its "
                f"unskipped blocks at the peak {t_block:.4f} ms, plain "
                f"{plain_ms:.4f} ms"
                + ("" if lib_ms is None else f", {lib_name} {lib_ms:.4f} ms")
                + ("" if twin_ms is None
                   else f", its dense-skip twin {twin_ms:.4f} ms"))
            i += 1
    torch.cuda.synchronize()
    parity.print_shares(K, False)
    if lm_train_pe["wq"]:
        plan = K.float_tile_plan(LM_STEP_ROWS, LM_HEADS * LM_DH, LM_PE_K)
        say(f"[timing] fused_pe_lm_train per launch ({card}): "
            + "; ".join(f"{proj} {statistics.mean(t[0] for t in v):.4f} ms "
                        f"against torch.matmul's "
                        f"{statistics.mean(t[1] for t in v):.4f} over "
                        f"{len(v)} launches"
                        for proj, v in lm_train_pe.items() if v)
            + f"; the float-x tile {plan.block_m}x{plan.block_n}: "
            f"{plan.mtiles * plan.ntiles} tiles ({plan.full} full), "
            f"{plan.ctas} CTAs, {K.FLOAT_TILE_RESIDENT} an SM")

    rows = []
    for row, tot in totals.items():
        kernel, policy, source, replaces = rows_map[row]
        out = {"name": row, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": paths[policy][2][kernel],
               "max_abs_err": parity.max_abs_err.get(row, 0.0),
               "ms": tot["ms"], "plain_ms": tot["plain_ms"],
               "bound_ms": tot["bound_ms"],
               "bound_by": ("bytes" if tot["bytes_s"] >= tot["ops_s"]
                            else "operations"),
               "library_ms": tot["library_ms"]}
        if kernel in ("fused_pe", "spike_matmul", "flash_attention"):
            out["gemm_route"] = "+".join(sorted(routes[row])) or "tile"
        if row in TILE_MS_BEFORE:
            host = tot_host[row]
            out["tile_route_ms"] = host["tile"]
            say(f"[timing] {row} ({out['gemm_route']} route): {tot['ms']:.4f}"
                f" ms device time, {host['tile']:.4f} ms on the tile route"
                f" (same operands, same clock; recorded before the decode "
                f"route: {TILE_MS_BEFORE[row]:.4f} ms by the host clock); host "
                f"clock now {host['ms']:.4f} ms against torch.matmul's "
                f"{host['lib']:.4f}; device time against torch.matmul's "
                f"{tot['library_ms']:.4f}: "
                f"{tot['library_ms'] / tot['ms']:.2f}x, "
                f"{tot['ms'] / tot['bound_ms']:.2f}x its bound")
        say(f"[timing] {row}: {out['ms']:.4f} ms per {policy} pass in "
            f"{out['launches']} launches; bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']}); unskipped blocks at the peak "
            f"{tot['block_ms']:.4f} ms; plain {out['plain_ms']:.4f} ms; "
            f"library {out['library_ms']}; positions near v_th "
            f"{parity.near_vth.get(row, 0)}"
            + (f"; bound under the launch floor ({out['launches']} x "
               f"{floor:.4f} ms)"
               if out["bound_ms"] < out["launches"] * floor else "")
            + (f"; dense-skip twin {tot['twin_ms']:.4f} ms"
               if tot["twin_ms"] else ""))
        rows.append(out)
    # a time below the least the card could take is a measurement fault (an
    # operand read from the L2, not from device memory)
    below = [f"{r['name']} {r['ms']:.4f} < {r['bound_ms']:.4f} ms"
             for r in rows if r["ms"] < r["bound_ms"]]
    require(not below, f"kernel times below their bound: {below}")
    return rows


# ------------------------------------------------------------------ phase 7
LM_ARCH = "qwen3-1.7b"
SERVE_POLICIES = ("fused_dense", "fused_packed", "reference")
SERVE_ENGINE = dict(max_slots=16, max_len=512, prefill_pad=64,
                    prefill_chunk=64, max_queue=32)
SERVE_REQUESTS = 32
SERVE_PROMPT = (16, 256)      # prompt lengths, inclusive
SERVE_MAX_NEW = (16, 32)      # tokens to generate, inclusive
PARITY_LAYERS = 4             # depth of the f32 parity variant
TICK_ITERS = 10               # timed decode ticks at 16 live slots


def serve_namespace():
    """The LM, engine and config entry points the serve and softmax phases
    drive."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.models import attention, layers
    from repro_torch.models.lm import LM, spike_totals
    from repro_torch.ops import attention as ops_attention
    from repro_torch.ops import with_policy
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.tree import tree_leaves

    return types.SimpleNamespace(
        get_config=get_config, build_model=build_model, LM=LM,
        spike_totals=spike_totals,
        spike_log=layers.spike_log, with_policy=with_policy, Engine=Engine,
        EngineConfig=EngineConfig, tree_leaves=tree_leaves,
        project_qkv=attention._project_qkv, attn_full=attention._attn_full,
        rmsnorm_apply=layers.rmsnorm_apply, attention=ops_attention)


def lm_trace(vocab: int) -> list:
    """The serving trace: (prompt, max_new) per request, all greedy."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for _ in range(SERVE_REQUESTS):
        n = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        prompt = rng.integers(0, vocab, n).astype(np.int32)
        out.append((prompt, int(rng.integers(SERVE_MAX_NEW[0],
                                             SERVE_MAX_NEW[1] + 1))))
    return out


def tick_launches(build_mod, n_layers: int) -> dict:
    """Launches of one decode tick (or prefill chunk) of a fused policy."""
    want = dict.fromkeys(build_mod.KERNELS, 0)
    want.update(fused_pe=2 * n_layers, spike_matmul=n_layers)
    return want


def run_engine(torch, S, build_mod, model, params, policy: str,
               trace, **engine_kw) -> dict:
    """The trace through one engine (``SERVE_ENGINE`` with ``engine_kw``
    over it); its tokens, stats, wall time, peak device memory and kernel
    launches (the counts set to 0 just before the engine is built and read
    just after it drains)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    eng = S.Engine(model, params, S.EngineConfig(
        **{**SERVE_ENGINE, **engine_kw}, policy=policy))
    uids = [eng.submit(p, max_new=n) for p, n in trace]
    fin = {r.uid: r for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build_mod.LAUNCHES)
    require(all(fin[u].status == "done" for u in uids),
            f"{policy}: a request did not finish")
    tokens = [fin[u].out for u in uids]
    for (_, n), out in zip(trace, tokens):
        require(len(out) == n, f"{policy}: {len(out)} tokens, asked {n}")
    ttft = sorted(fin[u].first_token_t - fin[u].enqueued_t for u in uids)
    return {"tokens": tokens, "stats": eng.stats(), "wall_s": wall,
            "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "base_gib": base / 2 ** 30,
            "ttft_p50_s": statistics.median(ttft)}


def direct_loop(torch, S, model, params, trace) -> tuple[list, dict]:
    """The engine's work without the engine: each prompt through
    ``prefill_chunk`` in the engine's chunks of its padded bucket, then
    ``decode_step`` over groups of ``max_slots`` requests (rows are
    independent and every call has the engine's shapes). Returns the
    greedy tokens and the per-layer spike totals of the whole loop."""
    chunk, slots = SERVE_ENGINE["prefill_chunk"], SERVE_ENGINE["max_slots"]
    pad, max_len = SERVE_ENGINE["prefill_pad"], SERVE_ENGINE["max_len"]
    dev = params["embed"]["emb"].device
    firsts = []
    with S.spike_log() as log:
        for prompt, _ in trace:
            s = len(prompt)
            bucket = min(max_len, -(-s // pad) * pad)
            cache = model.init_cache(1, bucket, device=dev)
            cache["len"] = torch.zeros((), dtype=torch.int32, device=dev)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
            toks[0, :s] = torch.tensor(prompt, device=dev)
            for lo in range(0, bucket, chunk):
                logits, cache = model.prefill_chunk(
                    params, toks[:, lo:lo + chunk], cache)
                if lo <= s - 1 < lo + chunk:
                    first = logits[0, s - 1 - lo].argmax()
            firsts.append(int(first))
        outs = []
        for g in range(0, len(trace), slots):
            group = trace[g:g + slots]
            out = [[firsts[g + i]] for i in range(len(group))]
            cache = model.init_cache(slots, max_len, device=dev)
            steps = max(n for _, n in group) - 1
            for _ in range(steps):
                toks = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
                toks[:len(group), 0] = torch.tensor([o[-1] for o in out],
                                                    device=dev)
                logits, cache = model.decode_step(params, toks, cache)
                nxt = logits.argmax(-1).tolist()
                for i, (_, n) in enumerate(group):
                    if len(out[i]) < n:
                        out[i].append(nxt[i])
            outs += out
    return outs, S.spike_totals(log, model.cfg.n_layers)


def capture_tick(torch, S, build_mod, model, params, what: str) -> tuple:
    """One decode tick at 16 slots, or one 64-token prefill chunk, its
    launch counts set to 0 just before it and read just after it."""
    dev = params["embed"]["emb"].device
    slots = SERVE_ENGINE["max_slots"]
    gen = torch.Generator(device=dev).manual_seed(2)
    if what == "decode":
        cache = model.init_cache(slots, SERVE_ENGINE["max_len"], device=dev)
        toks = torch.randint(0, model.cfg.vocab_size, (slots, 1),
                             generator=gen, device=dev)
        fn = model.decode_step
    else:
        chunk = SERVE_ENGINE["prefill_chunk"]
        cache = model.init_cache(1, chunk, device=dev)
        cache["len"] = torch.zeros((), dtype=torch.int32, device=dev)
        toks = torch.randint(0, model.cfg.vocab_size, (1, chunk),
                             generator=gen, device=dev)
        fn = model.prefill_chunk
    torch.cuda.synchronize()
    build_mod.reset_launches()
    with build_mod.capture_launches() as captured:
        fn(params, toks, cache)
        torch.cuda.synchronize()
    return dict(build_mod.LAUNCHES), captured, (fn, toks, cache)


def same_outputs(torch, a, b) -> bool:
    """Two launches' outputs (a tuple, or one tensor) equal bit for bit."""
    a, b = ((a,), (b,)) if isinstance(a, torch.Tensor) else (a, b)
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def replay_routes(torch, K, captured, label: str) -> int:
    """Every fused PE and spike matmul launch of one captured pass (all on
    the decode route) launched again on both routes: the decode route on
    its own operands (and a fused PE's also on the tile's padded ones,
    whose first rows it reads), against the tile route on the padded
    operands. Spikes,
    vld_next, packed words and K3's f32 output must be equal bit for bit,
    padded rows included. Returns the number replayed."""
    n = 0
    for name, args, _, route in captured:
        if name not in ("fused_pe", "spike_matmul"):
            continue
        require(route == "decode", f"{label}: a {name} launch of the "
                                   f"{route} route")
        targs = tile_args(K, name, args)
        launch = K.fused_pe_cuda if name == "fused_pe" else K.spike_matmul_cuda
        tile = launch(*targs)
        same = same_outputs(torch, launch(*args, route="decode"), tile)
        if name == "fused_pe":
            same = same and same_outputs(
                torch, launch(*targs, route="decode"), tile)
        require(same, f"{label}: {name} launch {n}: the decode route differs "
                      f"from the tile route")
        n += 1
    return n


def grouped_kv(cfg, captured) -> list:
    """A tick's captured launches, each grouped wk pass's inputs extended
    by the weight columns its product needs (``bound``): the kv heads'
    ``n_kv_heads * head_dim``, where the weight the kernel is handed
    repeats them for every query head."""
    dh = cfg.resolved_head_dim
    if cfg.n_kv_heads == cfg.n_heads:
        return captured
    out = []
    for launch in captured:
        inputs = launch.inputs
        if launch.name == "fused_pe" and inputs[4] is not None:  # wk, q-masked
            require(inputs[1].shape[1] == cfg.n_heads * dh,
                    f"a wk launch of {inputs[1].shape[1]} columns")
            launch = launch._replace(inputs=inputs + (cfg.n_kv_heads * dh,))
        out.append(launch)
    return out


def teacher_forced(torch, S, model, params, seqs) -> tuple:
    """Every trace sequence through ``prefill``: the argmax at each
    position and the per-layer spike totals."""
    dev = params["embed"]["emb"].device
    preds = []
    with S.spike_log() as log:
        for seq in seqs:
            toks = torch.tensor(seq, dtype=torch.int64, device=dev)[None]
            logits, _ = model.prefill(params, {"tokens": toks},
                                      return_all_logits=True)
            require(bool(torch.isfinite(logits).all()), "non-finite logits")
            preds.append(logits[0].argmax(-1))
    return torch.cat(preds), S.spike_totals(log, model.cfg.n_layers)


def agreement(torch, label: str, got, ref, rel_tol=None) -> tuple:
    """Top-1 agreement and the worst per-layer spike-total difference of
    two teacher-forced runs; gated when ``rel_tol`` is given."""
    (p, tot), (p_ref, tot_ref) = got, ref
    agree = float((p == p_ref).float().mean())
    worst = 0.0
    for kind, t in tot_ref.items():
        a = tot[kind].double()
        rel = ((a - t.double()).abs() / t.double().clamp_min(1.0))
        worst = max(worst, float(rel.max()))
        say(f"[serve] {label} spikes {kind} per layer: "
            f"{tot[kind].tolist()} vs {t.tolist()}")
    say(f"[serve] {label}: top-1 agreement {agree:.4f} over {p.numel()} "
        f"positions; worst per-layer spike-total rel diff {worst:.2e}")
    if rel_tol is not None:
        require(worst <= rel_tol, f"{label}: spike totals differ by {worst}")
        require(agree >= 0.99, f"{label}: top-1 agreement {agree} < 0.99")
    return agree, worst


def profile_tick(torch, S, build_mod, model, params, policy: str,
                 top: int = 12) -> tuple:
    """Decode ticks at 16 live slots: median ms and the tokens/s it
    implies, then ``torch.profiler`` over 3 ticks: busy and idle share,
    the top device ops, the kernels' time against the glue's. Returns
    (median ms, device busy ms or None where the profiler saw none)."""
    _, _, (fn, toks, cache) = capture_tick(torch, S, build_mod, model,
                                           params, "decode")
    times = []
    for i in range(TICK_ITERS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, toks, cache)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    slots = SERVE_ENGINE["max_slots"]
    say(f"[timing] serve {policy} decode tick at {slots} live slots: median "
        f"{med:.3f} ms (min {min(times):.3f}, max {max(times):.3f}) over "
        f"{TICK_ITERS}; {slots / med * 1e3:.1f} tokens/s")
    rows = device_rows(torch, lambda: fn(params, toks, cache), 3)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        say(f"[profile] serve {policy}: the profiler reported no device "
            f"time; breakdown not measured")
        return med, None
    ours = sum(r[0] for r in rows if any(k in r[2] for k in HAND_WRITTEN))
    launched = sum(r[1] for r in rows)
    say(f"[profile] serve {policy} decode tick: device busy {busy:.3f} ms "
        f"of median {med:.3f} ms in {launched} device kernels: idle share "
        f"{max(0.0, 1 - busy / med):.3f}; hand-written kernels {ours:.3f} "
        f"ms, everything else {busy - ours:.3f} ms")
    for ms, count, key in rows[:top]:
        say(f"[profile]   serve {policy} {ms:8.4f} ms  x{count:<4d} "
            f"{key[:100]}")
    return med, busy


def phase_serve(torch, S, K, build_mod, dev) -> dict:
    """The spiking QKFormer LM served at qwen3-1.7b's published width:
    the trace through the engine under each policy, the launches of a tick,
    the engine against a direct loop, packed against dense, the fused
    path against the reference on an f32 variant, and the timings."""
    cfg = S.get_config(LM_ARCH, spiking=True, attention_kind="qk_spiking")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = S.LM(cfg).init(gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in S.tree_leaves(params))
    say(f"[serve] {LM_ARCH} spiking qk_spiking: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv "
        f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {str(cfg.dtype)[6:]} activations, "
        f"{n_params} f32 parameters ({n_params * 4 / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    trace = lm_trace(cfg.vocab_size)
    say(f"[serve] trace: {len(trace)} requests, prompts "
        f"{min(len(p) for p, _ in trace)}-{max(len(p) for p, _ in trace)} "
        f"tokens ({sum(len(p) for p, _ in trace)} in all), max_new "
        f"{min(n for _, n in trace)}-{max(n for _, n in trace)}, greedy; "
        f"engine {SERVE_ENGINE}")
    want = tick_launches(build_mod, cfg.n_layers)
    paths, results, direct = {}, {}, {}
    compared = 0
    for policy in SERVE_POLICIES:
        model = S.LM(S.with_policy(cfg, policy))
        results[policy] = res = run_engine(torch, S, build_mod, model,
                                           params, policy, trace)
        st = res["stats"]
        say(f"[serve] {policy}: engine stats "
            + json.dumps({k: v for k, v in st.items() if k != "autotune"}))
        # every decode tick and prefill call of the engine's own run is
        # one pass over the layers; a reference run launches nothing
        calls = 0 if policy == "reference" else (st["decode_ticks"]
                                                 + st["prefill_calls"])
        want_run = {k: v * calls for k, v in want.items()}
        say(f"[serve] {policy} launches in the engine's run "
            f"({st['decode_ticks']} decode ticks, {st['prefill_calls']} "
            f"prefill calls): "
            f"{ {k: v for k, v in res['launches'].items() if v} }")
        require(res["launches"] == want_run, f"{policy} engine launches "
                                             f"{res['launches']} != "
                                             f"{want_run}")
        tokens, totals = direct_loop(torch, S, model, params, trace)
        direct[policy] = totals
        same = sum(a == b for a, b in zip(tokens, res["tokens"]))
        say(f"[serve] {policy}: engine tokens equal to the direct "
            f"prefill_chunk / decode_step loop for {same} of "
            f"{len(trace)} requests")
        require(same == len(trace),
                f"{policy}: engine tokens differ from the direct loop")
        if policy == "reference":
            continue
        for what in ("decode", "prefill chunk"):
            launches, captured, _ = capture_tick(torch, S, build_mod, model,
                                                 params, what.split()[0])
            say(f"[serve] {policy} launches in one {what}: "
                f"{ {k: v for k, v in launches.items() if v} }")
            require(launches == want, f"{policy} {what} launches "
                                      f"{launches} != {want}")
            replayed = replay_routes(torch, K, captured,
                                     f"serve {policy} {what}")
            compared += replayed
            say(f"[serve] {policy} {what}: {replayed} fused_pe and "
                f"spike_matmul launches replayed on both routes, decode "
                f"equal to the tile route bit for bit")
            paths[f"serve {policy} {what}"] = (
                None, None, launches, grouped_kv(model.cfg, captured))
        for name, args, *_ in paths[f"serve {policy} decode"][3]:
            packed = policy == "fused_packed"
            if name == "fused_pe":
                require(args[0].is_floating_point() and args[10].out == packed
                        and (args[5] is None or args[10].q == packed),
                        f"a {policy} fused_pe launch took the wrong operands")
            if name == "spike_matmul":
                require(args[3] is packed,
                        f"a {policy} spike_matmul launch took the wrong x")
    say(f"[serve] decode route bit-equal to the tile route on all "
        f"{compared} replayed launches (a decode tick and a prefill chunk "
        f"of fused_dense and fused_packed)")
    d, p = results["fused_dense"], results["fused_packed"]
    require(p["tokens"] == d["tokens"], "fused_packed tokens differ from "
                                        "fused_dense's")
    for kind, t in direct["fused_dense"].items():
        require(torch.equal(direct["fused_packed"][kind], t),
                f"fused_packed spike totals {kind} differ from fused_dense's")
    say(f"[serve] fused_packed tokens and per-layer spike totals equal "
        f"fused_dense's ({sum(len(t) for t in d['tokens'])} tokens)")
    same_ref = sum(a == b for a, b in zip(d["tokens"],
                                          results["reference"]["tokens"]))
    say(f"[serve] reference (bf16 products) tokens equal fused_dense's for "
        f"{same_ref} of {len(trace)} requests (information only)")
    for policy, res in results.items():
        st = res["stats"]
        say(f"[timing] serve {policy}: decode tick p50 "
            f"{st['decode_tick_p50_s'] * 1e3:.3f} ms, p99 "
            f"{st['decode_tick_p99_s'] * 1e3:.3f} ms over "
            f"{st['decode_ticks']} ticks; prefill chunk p50 "
            f"{st['prefill_call_p50_s'] * 1e3:.3f} ms over "
            f"{st['prefill_calls']}; TTFT mean {st['ttft_mean_s']:.3f} s, "
            f"p50 {res['ttft_p50_s']:.3f} s; {st['tokens']} tokens in "
            f"{res['wall_s']:.3f} s wall ({st['tok_per_s']:.1f} tokens/s); "
            f"peak device memory {res['peak_gib']:.3f} GiB, "
            f"{res['peak_gib'] - res['base_gib']:.3f} GiB above the "
            f"{res['base_gib']:.3f} GiB allocated before the engine (the "
            f"parameters and what earlier phases keep)")
    for policy in SERVE_POLICIES:
        profile_tick(torch, S, build_mod, S.LM(S.with_policy(cfg, policy)),
                     params, policy)
    seqs = [list(prompt) + out for (prompt, _), out in zip(trace,
                                                           d["tokens"])]
    info = {policy: teacher_forced(torch, S, S.LM(S.with_policy(cfg, policy)),
                                   params, seqs)
            for policy in ("fused_dense", "reference")}
    agreement(torch, f"{LM_ARCH} bf16 fused_dense vs reference "
              f"(information only)", info["fused_dense"], info["reference"])
    del params, info
    torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, n_layers=PARITY_LAYERS,
                               dtype=torch.float32)
    params4 = S.LM(cfg4).init(torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    runs = {policy: teacher_forced(torch, S,
                                   S.LM(S.with_policy(cfg4, policy)),
                                   params4, seqs)
            for policy in SERVE_POLICIES}
    agreement(torch, f"{LM_ARCH} {PARITY_LAYERS}-layer f32 fused_dense vs "
              f"reference", runs["fused_dense"], runs["reference"], 1e-3)
    agreement(torch, f"{LM_ARCH} {PARITY_LAYERS}-layer f32 fused_packed vs "
              f"reference", runs["fused_packed"], runs["reference"], 1e-3)
    del params4, runs
    torch.cuda.empty_cache()
    return paths


# ------------------------------------------------------------- phase 7b
CHAOS_POLICY = "fused_packed"
CHAOS_REPLICAS = 2            # engine replicas behind the router, one card
CHAOS_KILL_TICK = 12          # replica 1 dies at its 12th decode tick
CHAOS_NAN_TICKS = (6, 9)      # NaN injections on replica 0
CHAOS_RETRIES = 3             # slot -1 lets one request take all 3 poisonings
GUARD_REPS = 50               # timed guard scans on a live pool
# integrity_every of the clean runs: a warm-up with the guard on (the
# tick time drifts down over the first runs of a process), then A B B A
GUARD_ORDER = (1, 0, 1, 1, 0)


def chaos_namespace():
    """The router, the fault plan, the demotion log and the serving entry
    point the chaos phase drives."""
    from repro_torch.core.events import pad_lane_mask
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.attention import qk_spike_state_width
    from repro_torch.ops import fallback
    from repro_torch.serve import FaultPlan, ReplicaRouter, demo_chaos_plan

    return types.SimpleNamespace(
        FaultPlan=FaultPlan, ReplicaRouter=ReplicaRouter,
        demo_chaos_plan=demo_chaos_plan, fallback=fallback,
        serve_main=serve_main, pad_lane_mask=pad_lane_mask,
        qk_spike_state_width=qk_spike_state_width)


def count_engine_launches(build_mod, eng, tally: dict) -> None:
    """Add the launches each ``eng.step`` makes to ``tally``: the counts
    are global, so a replica's are the difference across its own steps."""
    step = eng.step

    def counted():
        before = dict(build_mod.LAUNCHES)
        try:
            return step()
        finally:
            for k, v in build_mod.LAUNCHES.items():
                tally[k] += v - before[k]

    eng.step = counted


def run_router(torch, S, C, build_mod, model, params, trace, faults=None,
               **engine_kw) -> dict:
    """The trace through a router of ``CHAOS_REPLICAS`` engines
    (``SERVE_ENGINE`` with ``engine_kw`` over it) sharing the card: each
    request's tokens (by trace order), the router, its stats, each
    replica's kernel launches (counted over its own steps, from 0 when the
    router is built) and the decode ticks' wall times."""
    torch.cuda.synchronize()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        router = C.ReplicaRouter(model, params, S.EngineConfig(
            **{**SERVE_ENGINE, **engine_kw}, policy=CHAOS_POLICY),
            n_replicas=CHAOS_REPLICAS, faults=faults)
        tallies = [dict.fromkeys(build_mod.KERNELS, 0)
                   for _ in router.engines]
        for eng, tally in zip(router.engines, tallies):
            count_engine_launches(build_mod, eng, tally)
        uids = [router.submit(p, max_new=n) for p, n in trace]
        fin = router.run_until_drained()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for w in caught:
        say(f"[chaos] warning: {w.category.__name__}: {w.message}")
    by_uid = {r.uid: r for r in fin}
    require(sorted(by_uid) == sorted(uids) and len(fin) == len(uids),
            "a request did not finish exactly once")
    require(all(by_uid[u].status == "done" for u in uids),
            f"statuses {sorted({r.status for r in fin})}, not all done")
    tokens = [by_uid[u].out for u in uids]
    for (_, n), out in zip(trace, tokens):
        require(len(out) == n, f"{len(out)} tokens, asked {n}")
    ticks = [t for e in router.engines for t in e._tick_wall]
    return {"tokens": tokens, "uids": uids, "router": router,
            "stats": router.stats(), "launches": tallies, "wall_s": wall,
            "ticks": ticks}


def require_clean(C, res: dict, want: dict, label: str) -> None:
    """A fault-free router run: no failover, no demotion, no quarantine,
    and each replica's launches one pass of the layers a decode tick and
    a prefill call."""
    st = res["stats"]
    require(st["failovers"] == 0 and st["alive"] == [True] * CHAOS_REPLICAS,
            f"{label}: failovers {st['failures']}")
    require(C.fallback.demotions() == [],
            f"{label}: demotions {C.fallback.demotions()}")
    for r, (per, got) in enumerate(zip(st["per_replica"], res["launches"])):
        require(per["quarantined"] == 0, f"{label}: replica {r} quarantined "
                                         f"{per['quarantined']}")
        calls = per["decode_ticks"] + per["prefill_calls"]
        want_run = {k: v * calls for k, v in want.items()}
        require(got == want_run, f"{label}: replica {r} launches {got} != "
                                 f"{want_run}")


def planned_death(st: dict) -> bool:
    """The router's one failure is the chaos plan's kill of its last
    replica, not another exception in a replica's step."""
    return [(f["replica"], f["reason"]) for f in st["failures"]] == [
        (CHAOS_REPLICAS - 1,
         f"step raised: injected replica death at tick {CHAOS_KILL_TICK}")]


def tick_pcts(ticks) -> tuple:
    import numpy as np

    t = np.asarray(ticks) * 1e3
    return float(np.percentile(t, 50)), float(np.percentile(t, 99)), len(t)


def time_guard(torch, eng, vocab: int) -> tuple:
    """The guard's own cost on a replica's live pool, apart from the
    tick's spread: median host ms of the tick's one read (the greedy
    tokens, read as ``Engine.step`` reads them) without and with the scan
    (``Engine._integrity_verdict``) on
    f32 logits of the pool's shape, each synchronised by its read, in
    turns; and the scan's device ms (CUDA events)."""
    gen = torch.Generator(device=eng.device).manual_seed(3)
    logits = torch.randn((eng.cfg.max_slots, vocab), generator=gen,
                         device=eng.device)

    def read(scan: bool):
        greedy = torch.argmax(logits, dim=-1)
        if not scan:
            return greedy.tolist()
        rows = [greedy] + eng._integrity_verdict(logits)
        return torch.stack([r.to(torch.int64) for r in rows]).tolist()

    host = {False: [], True: []}
    for _ in range(GUARD_REPS):
        for scan in (False, True, True, False):
            t0 = time.perf_counter()
            read(scan)
            host[scan].append((time.perf_counter() - t0) * 1e3)
    dev_ms = device_time(torch, lambda: eng._integrity_verdict(logits),
                         GUARD_REPS)
    return (statistics.median(host[False]), statistics.median(host[True]),
            dev_ms)


def phase_chaos(torch, S, C, build_mod, dev, smi: str) -> None:
    """Self-healing serving at qwen3-1.7b's published width: the spiking
    LM under ``fused_packed`` through a router of two replicas on the
    card, the integrity guard on every tick. Clean runs (guard off and on:
    the guard's cost; launches gated), the chaos run (replica 1 killed,
    two NaN injections, a corrupted packed word and a consumer stall on
    replica 0, ``dense_lif`` failed at its first call) against a run whose
    only fault is that kernel fault, K2 back after ``fallback.reset()``,
    and the serving entry point under ``--chaos``."""
    t_phase = time.perf_counter()
    cfg = S.get_config(LM_ARCH, spiking=True, attention_kind="qk_spiking")
    params = S.LM(cfg).init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    model = S.LM(S.with_policy(cfg, CHAOS_POLICY))
    trace = lm_trace(cfg.vocab_size)
    want = tick_launches(build_mod, cfg.n_layers)
    say(f"[chaos] {LM_ARCH} spiking qk_spiking under {CHAOS_POLICY}: "
        f"{len(trace)} requests through {CHAOS_REPLICAS} replicas sharing "
        f"the card, engine {SERVE_ENGINE}")
    guard = {0: [], 1: []}
    clean = last = None
    for i, every in enumerate(GUARD_ORDER):
        res = run_router(torch, S, C, build_mod, model, params, trace,
                         integrity_every=every)
        require_clean(C, res, want, f"clean run, integrity_every {every}")
        if i:
            guard[every] += res["ticks"]
        scans = sum(p["guard_scans"] for p in res["stats"]["per_replica"])
        require((scans > 0) == bool(every), f"{scans} guard scans at "
                                            f"integrity_every {every}")
        if every and clean is None:
            clean = res
        last = res
        p50, p99, n = tick_pcts(res["ticks"])
        say(f"[chaos] clean run{' (warm-up)' if not i else ''}, "
            f"integrity_every {every}: "
            f"{res['stats']['tokens']} tokens in {res['wall_s']:.3f} s, "
            f"decode tick p50 / p99 {p50:.3f} / {p99:.3f} ms over {n}, "
            f"dispatch {res['stats']['dispatch']}, {scans} guard scans; "
            f"launches per replica "
            f"{[{k: v for k, v in t.items() if v} for t in res['launches']]}"
            f" = {want} x (decode ticks + prefill calls)")
    off, on = tick_pcts(guard[0]), tick_pcts(guard[1])
    say(f"[timing] chaos guard cost ({smi}): clean decode tick p50 / p99 "
        f"{on[0]:.3f} / {on[1]:.3f} ms over {on[2]} ticks with "
        f"integrity_every 1, {off[0]:.3f} / {off[1]:.3f} ms over {off[2]} "
        f"with 0 (after a warm-up, runs off, on, on, off): p50 "
        f"{on[0] - off[0]:+.3f} ms "
        f"({(on[0] / off[0] - 1) * 100:+.2f} %), p99 {on[1] - off[1]:+.3f} "
        f"ms")
    plain_ms, scan_ms, dev_ms = time_guard(torch, last["router"].engines[0],
                                           cfg.vocab_size)
    say(f"[timing] chaos guard alone ({smi}): the tick's read "
        f"{plain_ms:.4f} ms host without the scan, {scan_ms:.4f} with it "
        f"({scan_ms - plain_ms:+.4f} ms; median of {GUARD_REPS} each, in "
        f"turns); the scan's device time {dev_ms:.4f} ms (cold L2)")
    del last

    C.fallback.reset()
    only_kernel = run_router(
        torch, S, C, build_mod, model, params, trace,
        faults=C.FaultPlan(0).fail_kernel("dense_lif", 0),
        integrity_every=1, quarantine_retries=CHAOS_RETRIES)
    kst = only_kernel["stats"]
    require(kst["failovers"] == 0 and sum(
        p["quarantined"] for p in kst["per_replica"]) == 0,
        f"kernel-only run: {kst['failures']}")
    kdem = C.fallback.demotions()
    require([d["op"] for d in kdem] == ["dense_lif"],
            f"kernel-only run demotions {kdem}")
    C.fallback.reset()
    plan = (C.demo_chaos_plan(0, n_replicas=CHAOS_REPLICAS,
                              kill_tick=CHAOS_KILL_TICK,
                              nan_ticks=CHAOS_NAN_TICKS)
            .corrupt_word(8).stall_consumer(4, ticks=3))
    chaos = run_router(torch, S, C, build_mod, model, params, trace,
                       faults=plan, integrity_every=1,
                       quarantine_retries=CHAOS_RETRIES)
    st = chaos["stats"]
    dem = C.fallback.demotions()
    per = [{**dict.fromkeys(("quarantined", "requeues", "failed",
                             "stall_ticks"), 0), **p}
           for p in st["per_replica"]]    # a replica that finished nothing
    quarantined = sum(p["quarantined"] for p in per)
    say(f"[chaos] chaos run: alive {st['alive']}, failovers "
        f"{st['failovers']} ({[f['reason'] for f in st['failures']]}), "
        f"requeued {st['requeued']}, dispatch {st['dispatch']}, "
        f"quarantined {quarantined} "
        f"({[p['quarantined'] for p in per]}), requeues "
        f"{[p['requeues'] for p in per]}, failed "
        f"{[p['failed'] for p in per]}, stall ticks "
        f"{[p['stall_ticks'] for p in per]}, demotions "
        f"{[(d['op'], d['mode'], d['reason']) for d in dem]}; plan "
        f"{json.dumps(plan.summary())}; {st['tokens']} tokens in "
        f"{chaos['wall_s']:.3f} s")
    require(st["alive"] == [True, False], f"alive {st['alive']}")
    # the one failover must be the planned death: any other exception in a
    # replica's step would fail over too while the other one lives
    require(st["failovers"] == 1 and planned_death(st),
            f"failovers {st['failures']}")
    # the guard sees a corrupted word only in its pad lanes: at a width
    # whose n_heads * head_dim fills the word grid there are none, as in
    # the reference, and the word is rewritten by the next tick unread
    width = C.qk_spike_state_width(cfg)
    pad = bool(C.pad_lane_mask(cfg.n_heads * cfg.resolved_head_dim,
                               width).any())
    visible = len(CHAOS_NAN_TICKS) + pad
    say(f"[chaos] the packed state has {width} words a row for "
        f"{cfg.n_heads * cfg.resolved_head_dim} units: "
        + ("pad lanes, so the corrupted word is flagged" if pad else
           "no pad lane, so the guard cannot see the corrupted word (it "
           "is rewritten, unread, by the slot's next tick)")
        + f"; {visible} poisonings the guard can flag")
    require(quarantined >= visible, f"{quarantined} quarantines, "
                                    f"{visible} poisonings visible")
    require(st["requeued"] >= 1, f"requeued {st['requeued']}")
    require([d["op"] for d in dem] == ["dense_lif"]
            and dem[0]["reason"].startswith("InjectedKernelFault"),
            f"demotions {dem}")
    same = sum(a == b for a, b in zip(chaos["tokens"],
                                      only_kernel["tokens"]))
    say(f"[chaos] chaos tokens equal the kernel-only run's for {same} of "
        f"{len(trace)} requests")
    require(same == len(trace), "chaos tokens differ from the kernel-only "
                                "run's")
    for u, toks in zip(chaos["uids"], chaos["tokens"]):
        require(chaos["router"].pop_output(u) == toks,
                f"request {u}: the popped output is not its tokens")
        require(chaos["router"].pop_output(u) == [],
                f"request {u}: a second pop returned tokens")
    say(f"[chaos] every request finished once with status done; each "
        f"popped output came out once, a second pop returned []")
    for label, res in (("chaos", chaos), ("kernel-only", only_kernel)):
        agree = sum(a == b for a, b in zip(res["tokens"], clean["tokens"]))
        say(f"[chaos] {label} run (dense_lif on its reference) tokens equal "
            f"the clean fused run's for {agree} of {len(trace)} requests "
            f"(information only: at bf16 the reference dense_lif and K2 "
            f"are two functions; {smi})")

    C.fallback.reset()
    launches, _, _ = capture_tick(torch, S, build_mod, model, params,
                                  "decode")
    require(launches == want, f"after fallback.reset() a tick launches "
                              f"{launches} != {want}")
    say(f"[chaos] after fallback.reset(): one decode tick launches "
        f"{ {k: v for k, v in launches.items() if v} }, K2 back")
    del params, only_kernel, chaos, clean, res
    torch.cuda.empty_cache()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        est = C.serve_main(["--arch", LM_ARCH, "--spiking",
                            "--qk-attention", "--policy", CHAOS_POLICY,
                            "--replicas", str(CHAOS_REPLICAS), "--chaos",
                            "--slots", str(SERVE_ENGINE["max_slots"]),
                            "--max-len", str(SERVE_ENGINE["max_len"]),
                            "--prefill-chunk",
                            str(SERVE_ENGINE["prefill_chunk"])])
    for w in caught:
        say(f"[chaos] warning: {w.category.__name__}: {w.message}")
    edem = [d["op"] for d in C.fallback.demotions()]
    say(f"[chaos] launch.serve --replicas {CHAOS_REPLICAS} --chaos: "
        f"{est['n']} requests done, {est['tokens']} tokens, alive "
        f"{est['alive']}, failovers {est['failovers']}, requeued "
        f"{est['requeued']}, quarantined "
        f"{[p.get('quarantined') for p in est['per_replica']]}, demotions "
        f"{edem}")
    require(est["failovers"] == 1 and planned_death(est)
            and est["n"] == 16 and edem == ["dense_lif"],
            f"launch.serve --chaos: failovers {est['failures']}")
    C.fallback.reset()
    torch.cuda.empty_cache()
    say(f"[chaos] phase {time.perf_counter() - t_phase:.1f} s ({smi})")


# ------------------------------------------------------------------ phase 8
F8_REQUESTS = 8               # requests of the f8-KV engine gate
INFO_PROMPTS = 8              # prompts of the bf16 chunked-vs-blocking print
# K9 parity sweep: (H, Hkv), D, and S with the causal flags it is run at
K9_HEADS = ((16, 8), (16, 16), (16, 1))
K9_DIMS = (128, 64, 32)
K9_SEQS = ((64, (True, False)), (300, (True,)), (2048, (True, False)))
# B 1, H 16 over Hkv 8, D 128, causal (S 248: the f32 LM variant's prefill)
K9_TIMING_S = (248, 512, 2048, 8192)
# head dims the wgmma route reaches at a padded instance (bf16), and the
# scalar route's other instances and its general one (37), each checked
# at H 16/8, S 300 causal and S 2048 full; the padded ones also timed at S
# 2048 beside SDPA
K9_PADDED_DIMS = (96, 112, 48)
K9_OTHER_DIMS = K9_PADDED_DIMS + (37,)
# f32 targets of the scalar route (ms at S 2048 and 8192, B 1, H 16/8, D
# 128, causal): half its bound at 8192, and a time at 2048; printed beside
# the measurement, not gated
K9_F32_TARGET_MS = {2048: 0.60, 8192: 8.21}
# (s, h, hkv, d, causal): q scaled by 8 (scores up to about 40), held
# against an f64 result; at D 128 the scale is no power of two
K9_SCALED = ((300, 16, 8, 128, True), (2048, 16, 16, 64, False))


def put_slot(pool, new, slot: int, kind: str = "kv") -> None:
    """A request's prefill cache written into row ``slot`` of a pool of
    the same tree: a KV entry's first rows ([.., B, S, H, D]; none for an
    empty one), a mamba state whole ("ssm" [.., B, H, P, N], "conv" [..,
    B, K-1, C])."""
    if isinstance(pool, dict):
        for key in pool:
            put_slot(pool[key], new[key], slot,
                     key if key in ("ssm", "conv") else kind)
        return
    if isinstance(pool, (tuple, list)):
        for p, n in zip(pool, new):
            put_slot(p, n, slot, kind)
        return
    dst = pool.narrow(pool.ndim - (3 if kind == "conv" else 4), slot, 1)
    if kind == "kv":
        if new.shape[-3] == 0:
            return
        dst = dst.narrow(dst.ndim - 3, 0, new.shape[-3])
    dst.copy_(new.to(pool.dtype))


def pool_direct_loop(torch, S, model, params, trace, chunked: bool
                     ) -> list:
    """The engine's work without the engine, at its shapes: each prompt
    padded to its bucket (its true length for the ssm and hybrid
    families) and prefilled whole or in the engine's chunks (rounded up to
    ``prefill_chunk_align``), its cache written into a slot of a
    ``max_slots`` pool of ``max_len`` rows, then ``decode_step`` over the
    pool, ``max_slots`` requests at a time, with a per-slot length vector
    (rows past a slot's length are masked and the slots' states are
    rows of their own, so the slots do not see each other). Returns greedy
    tokens."""
    slots, pad = SERVE_ENGINE["max_slots"], SERVE_ENGINE["prefill_pad"]
    max_len = SERVE_ENGINE["max_len"]
    align = model.cfg.prefill_chunk_align
    chunk = -(-SERVE_ENGINE["prefill_chunk"] // align) * align
    recurrent = model.cfg.family in ("ssm", "hybrid")
    dev = params["embed"]["emb"].device
    outs = []
    for g in range(0, len(trace), slots):
        group = trace[g:g + slots]
        pool = model.init_cache(slots, max_len, device=dev)
        out, lens = [], []
        for i, (prompt, _) in enumerate(group):
            s = len(prompt)
            bucket = s if recurrent else min(max_len, -(-s // pad) * pad)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
            toks[0, :s] = torch.tensor(prompt, device=dev)
            if chunked:
                cache = model.init_cache(1, bucket, device=dev)
                cache["len"] = torch.zeros((), dtype=torch.int32, device=dev)
                for lo in range(0, bucket, chunk):
                    logits, cache = model.prefill_chunk(
                        params, toks[:, lo:lo + chunk], cache)
                    if lo <= s - 1 < lo + chunk:
                        first = logits[0, s - 1 - lo].argmax()
            else:
                logits, cache = model.prefill(params, {"tokens": toks},
                                              return_all_logits=True)
                first = logits[0, s - 1].argmax()
            put_slot(pool["layers"], cache["layers"], i)
            out.append([int(first)])
            lens.append(s)
        lens += [0] * (slots - len(group))
        for t in range(max(n for _, n in group) - 1):
            toks = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
            toks[:len(group), 0] = torch.tensor([o[-1] for o in out],
                                                device=dev)
            pool["len"] = torch.tensor(
                [n + t if i < len(group) else 0 for i, n in enumerate(lens)],
                dtype=torch.int32, device=dev)
            logits, pool = model.decode_step(params, toks, pool)
            nxt = logits.argmax(-1).tolist()
            for i, (_, n) in enumerate(group):
                if len(out[i]) < n:
                    out[i].append(nxt[i])
        outs += out
    return outs


def chunked_logits(torch, model, params, toks):
    """All-position logits of ``toks`` [1, S] fed through
    ``prefill_chunk`` in the engine's chunks (rounded up to
    ``prefill_chunk_align``)."""
    align = model.cfg.prefill_chunk_align
    chunk = -(-SERVE_ENGINE["prefill_chunk"] // align) * align
    dev = toks.device
    cache = model.init_cache(1, toks.shape[1], device=dev)
    cache["len"] = torch.zeros((), dtype=torch.int32, device=dev)
    parts = []
    for lo in range(0, toks.shape[1], chunk):
        logits, cache = model.prefill_chunk(params, toks[:, lo:lo + chunk],
                                            cache)
        parts.append(logits)
    return torch.cat(parts, dim=1)


def chunked_vs_blocking(torch, model, params, prompts, label: str,
                        tol=None) -> None:
    """Each prompt's blocking-prefill logits against its chunked ones: the
    largest difference and the greedy agreement; gated at ``tol``."""
    worst, same, n = 0.0, 0, 0
    for prompt in prompts:
        toks = torch.tensor(prompt, dtype=torch.int64,
                            device=params["embed"]["emb"].device)[None]
        full, _ = model.prefill(params, {"tokens": toks},
                                return_all_logits=True)
        got = chunked_logits(torch, model, params, toks)
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        worst = max(worst, float((got - full).abs().max()))
        same += int((got.argmax(-1) == full.argmax(-1)).sum())
        n += toks.shape[1]
        if tol is not None:
            require(torch.allclose(got, full, rtol=tol, atol=tol),
                    f"{label}: chunked logits differ from blocking by "
                    f"{worst}")
    say(f"[softmax] {label}: chunked against blocking prefill over "
        f"{len(prompts)} prompts: largest logit difference {worst:.3e}, "
        f"greedy agreement {same / n:.4f} ({n} positions)"
        + ("" if tol is None else f"; gate rtol = atol = {tol}")
        + ("" if tol is not None else " (information only)"))
    if tol is not None:
        require(same == n, f"{label}: greedy tokens differ")


def k9_on_lm_operands(torch, S, K, build_mod, model, params, prompt,
                      parity: Parity, label: str):
    """Layer 0's q, k and v (after RoPE, before any KV expansion) of a
    prefill of ``prompt`` through ``ops.attention(policy="fused_dense")``,
    its launch counts set to 0 just before and read just after. Returns
    (launches, captured, out, q, k, v)."""
    cfg = model.cfg
    dev = params["embed"]["emb"].device
    toks = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
    x, positions = model._embed(params, {"tokens": toks})
    p0 = params["blocks"][0]
    y = S.rmsnorm_apply(p0["ln1"], x, cfg.rms_eps)
    q, k, v = S.project_qkv(p0["attn"], cfg, y, positions, cfg.n_heads,
                            cfg.n_kv_heads)
    torch.cuda.synchronize()
    build_mod.reset_launches()
    with build_mod.capture_launches() as captured:
        out = S.attention(q, k, v, causal=True, policy="fused_dense")
        torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    want = {**dict.fromkeys(build_mod.KERNELS, 0), "flash_attention": 1}
    require(launches == want, f"{label}: ops.attention launches {launches}")
    route = captured[0].route
    require(route == K.flash_pick_route(q), f"{label}: ops.attention took "
                                            f"the {route} route")
    ok, err, _ = flash_gate(torch, K, out, q, k, v, True)
    require(ok, f"{label}: ops.attention's own output ({route} route) "
                f"against the plain version, max abs err {err}")
    say(f"[softmax] {label}: ops.attention launched K9 once, on the {route} "
        f"route")
    for r in flash_routes(K, q):
        check_flash(torch, K, captured[0].args, parity, label, r)
    return launches, captured, out, q, k, v


def parity_k9(torch, K, gen, dev, parity: Parity) -> None:
    """K9 against its plain version on seeded operands: causal and full,
    H / Hkv 16/8, 16/16, 16/1, D 128, 64, 32, S 64, 300 (ragged, causal)
    and 2048, f32 (the scalar route) and bf16 (the wgmma and the scalar
    routes); then D 96, 112, 48 (bf16 on the wgmma route at a padded
    instance, and on the scalar route) and 37 (the scalar route's general
    instance; bf16 has no TMA stride there), f32 and bf16, H 16/8, S 300
    causal and 2048 full; then q scaled by 8 (``check_flash_scaled``)."""
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for h, hkv in K9_HEADS:
            for d in K9_DIMS:
                for s, causals in K9_SEQS:
                    q = torch.randn((1, s, h, d), generator=gen,
                                    device=dev).to(dtype)
                    k = torch.randn((1, s, hkv, d), generator=gen,
                                    device=dev).to(dtype)
                    v = torch.randn((1, s, hkv, d), generator=gen,
                                    device=dev).to(dtype)
                    for causal, route in itertools.product(
                            causals, flash_routes(K, q)):
                        check_flash(torch, K, (q, k, v, causal), parity,
                                    f"sweep {str(dtype)[6:]} S {s} H {h}/"
                                    f"{hkv} D {d} "
                                    f"{'causal' if causal else 'full'}",
                                    route)
                        n += 1
    for dtype in (torch.float32, torch.bfloat16):
        for d in K9_OTHER_DIMS:
            for s, causal in ((300, True), (2048, False)):
                q = torch.randn((1, s, 16, d), generator=gen,
                                device=dev).to(dtype)
                k, v = (torch.randn((1, s, 8, d), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
                want = ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0
                        else "scalar")
                require(K.flash_pick_route(q) == want,
                        f"{dtype} at D {d} must take the {want} route")
                for route in flash_routes(K, q):
                    check_flash(torch, K, (q, k, v, causal), parity,
                                f"sweep {str(dtype)[6:]} S {s} H 16/8 D {d} "
                                f"{'causal' if causal else 'full'}", route)
                    n += 1
    check_flash_scaled(torch, K, gen, dev)
    say(f"[parity] flash_attention: {n} sweep launches agree with the "
        f"plain version")


def time_k9(torch, K, gen, dev, parity: Parity, card: str) -> None:
    """K9 at B 1, H 16 over Hkv 8, D 128, causal, S in ``K9_TIMING_S``, f32
    and bf16, by device time with a cold L2 (``device_time``), all on the
    same operands: each route (at bf16 the wgmma and the scalar route; at
    f32 the scalar route), its plain version, SDPA (and the backend SDPA
    took) and the bound (``flash_ops_ms``); beside the bf16 bound, for
    information, the one-pass floor (every operation once at the bf16
    tensor-core rate: what a bf16 p would need, which the reference's f32 p
    rules out). Fails if a route reads below its bound."""
    below = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for s in K9_TIMING_S:
            q = torch.randn((1, s, 16, 128), generator=gen, device=dev).to(
                dtype)
            k = torch.randn((1, s, 8, 128), generator=gen, device=dev).to(
                dtype)
            v = torch.randn((1, s, 8, 128), generator=gen, device=dev).to(
                dtype)
            args = (q, k, v, True)
            label = f"timing {dt} S {s}"
            reps = max(3, 40960 // s)
            nbytes, ops, _ = flash_bound(*args)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flash_ops_ms(q, ops)
            bound = max(t_bytes, t_ops)
            times = {}
            for route in flash_routes(K, q):
                check_flash(torch, K, args, parity, label, route)
                times[route] = device_time(
                    torch, lambda: K.flash_attention_cuda(*args, route=route),
                    reps)
            plain_ms = device_time(torch, lambda: K.attention_ref(
                q, k, v, causal=True), max(2, reps // 4), warmup=1)
            sdpa = sdpa_call(torch, *args)
            sdpa_ms = device_time(torch, sdpa, reps)
            backend = sdpa_backend(torch, *args)
            for route, ms in times.items():
                say(f"[timing] flash_attention {dt} B 1 S {s} H 16/8 D 128 "
                    f"causal ({route} route): {ms:.4f} ms; bound {bound:.4f} "
                    f"ms ({'bytes' if t_bytes >= t_ops else 'operations'}: "
                    f"{nbytes / 1e6:.3f} MB, {ops / 1e9:.3f} GFLOP"
                    + (", QK^T once and PV three times at the bf16 "
                       "tensor-core rate" if dtype == torch.bfloat16
                       else " at the f32 rate")
                    + f"), roofline share {bound / ms:.3f}; SDPA "
                    f"{sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x SDPA's time) "
                    f"[{card}]")
                if ms < bound:
                    below.append(f"{label} {route} route {ms:.4f} < "
                                 f"{bound:.4f} ms")
            if dtype == torch.bfloat16:
                floor = max(t_bytes, ops / PEAK_BF16_TC_OPS_PER_S * 1e3)
                say(f"[timing] flash_attention bf16 S {s}: the wgmma route "
                    f"{times['wgmma']:.4f} ms, "
                    f"{times['scalar'] / times['wgmma']:.2f}x faster than "
                    f"the scalar route's {times['scalar']:.4f} ms on the same "
                    f"operands; one-pass floor (PV once, p in bf16, not the "
                    f"reference's function) {floor:.4f} ms, for information")
            say(f"[timing] flash_attention {dt} S {s}: plain {plain_ms:.4f} "
                f"ms; SDPA {sdpa_ms:.4f} ms, backend {backend}")
            if dtype == torch.float32:
                ms = times["scalar"]
                target = K9_F32_TARGET_MS.get(s)
                say(f"[timing] flash_attention f32 S {s} target: the scalar "
                    f"route {ms:.4f} ms against SDPA's {sdpa_ms:.4f} "
                    f"({'met' if ms <= sdpa_ms else 'missed'}: no slower "
                    f"than SDPA)"
                    + ("" if target is None else
                       f", against {target:.2f} ms "
                       f"({'met' if ms <= target else 'missed'})")
                    + f"; {bound / ms:.3f} of its bound [{card}]")
            del q, k, v, args, sdpa
            torch.cuda.empty_cache()
    for d in K9_PADDED_DIMS[:2]:
        s = 2048
        q = torch.randn((1, s, 16, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((1, s, 8, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        args = (q, k, v, True)
        nbytes, ops, _ = flash_bound(*args)
        bound = max(nbytes / PEAK_BYTES_PER_S * 1e3, flash_ops_ms(q, ops))
        times = {}
        for route in flash_routes(K, q):
            check_flash(torch, K, args, parity, f"timing bf16 S {s} D {d}",
                        route)
            times[route] = device_time(
                torch, lambda: K.flash_attention_cuda(*args, route=route), 20)
        sdpa_ms = device_time(torch, sdpa_call(torch, *args), 20)
        say(f"[timing] flash_attention bf16 B 1 S {s} H 16/8 D {d} causal: "
            f"wgmma route (at its {K.flash_wgmma_instance(d)} instance) "
            f"{times['wgmma']:.4f} ms, scalar route {times['scalar']:.4f} ms;"
            f" bound {bound:.4f} ms (operations: QK^T once and PV three "
            f"times at the bf16 tensor-core rate, on D {d}), roofline share "
            f"{bound / times['wgmma']:.3f}; SDPA {sdpa_ms:.4f} ms "
            f"({times['wgmma'] / sdpa_ms:.2f}x SDPA's time), backend "
            f"{sdpa_backend(torch, *args)} [{card}]")
        for route, ms in times.items():
            if ms < bound:
                below.append(f"bf16 D {d} {route} route {ms:.4f} < "
                             f"{bound:.4f} ms")
        del q, k, v, args
        torch.cuda.empty_cache()
    require(not below, f"K9 times below their bound: {below}")


def phase_softmax(torch, S, K, build_mod, dev, parity: Parity) -> dict:
    """qwen3-1.7b as published (softmax attention, GQA, qk_norm, RoPE, a
    KV cache) served through the engine, gated against a direct loop,
    chunked against blocking prefill, and with an f8 KV pool; K9 on the
    LM's prefill operands and its parity sweep; the timings. Returns the
    K9 path for the timing phase's rows."""
    cfg = S.get_config(LM_ARCH)
    require(cfg.attention_kind == "softmax" and not cfg.spiking,
            f"{LM_ARCH} is not the published softmax model")
    card = gpu_name_and_power()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = S.LM(cfg)
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in S.tree_leaves(params))
    kv_gb = (2 * cfg.n_layers * SERVE_ENGINE["max_slots"]
             * SERVE_ENGINE["max_len"] * cfg.n_kv_heads
             * cfg.resolved_head_dim * 2 / 1e9)
    say(f"[softmax] {LM_ARCH} as published: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
        f"{cfg.resolved_head_dim}, qk_norm {cfg.qk_norm}, RoPE theta "
        f"{cfg.rope_theta:g}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{str(cfg.dtype)[6:]} activations, {n_params} f32 parameters, "
        f"bf16 KV pool {kv_gb:.3f} GB; init "
        f"{time.perf_counter() - t0:.1f} s; card {card}")
    trace = lm_trace(cfg.vocab_size)
    zero = dict.fromkeys(build_mod.KERNELS, 0)
    results = {}
    for mode, chunk in (("chunked", SERVE_ENGINE["prefill_chunk"]),
                        ("blocking", 0)):
        res = results[mode] = run_engine(torch, S, build_mod, model, params,
                                         None, trace, prefill_chunk=chunk)
        st = res["stats"]
        say(f"[softmax] engine {mode} prefill: stats "
            + json.dumps({k: v for k, v in st.items() if k != "autotune"}))
        require(res["launches"] == zero, f"softmax engine {mode}: launches "
                                         f"{res['launches']}")
        tokens = pool_direct_loop(torch, S, model, params, trace,
                                  chunked=chunk > 0)
        same = sum(a == b for a, b in zip(tokens, res["tokens"]))
        say(f"[softmax] engine {mode}: tokens equal to the direct "
            f"{'prefill_chunk' if chunk else 'prefill'} / decode_step loop "
            f"for {same} of {len(trace)} requests; no kernel launched "
            f"({st['decode_ticks']} decode ticks, {st['prefill_calls']} "
            f"prefill calls)")
        require(same == len(trace), f"softmax engine {mode}: tokens differ "
                                    f"from the direct loop")
    same = sum(a == b for a, b in zip(results["chunked"]["tokens"],
                                      results["blocking"]["tokens"]))
    say(f"[softmax] engine chunked tokens equal blocking's for {same} of "
        f"{len(trace)} requests (information; the gate is the f32 "
        f"variant's)")
    for what in ("decode", "prefill chunk"):
        launches, _, _ = capture_tick(torch, S, build_mod, model, params,
                                      what.split()[0])
        require(launches == zero, f"softmax {what}: launches {launches}")
        say(f"[softmax] one {what}: no kernel launched, as in the reference")

    # the f8 KV pool: chunked prefill quantizes once, at the slot write
    f8_model = S.LM(dataclasses.replace(cfg, kv_dtype="f8_e4m3"))
    f8 = {mode: run_engine(torch, S, build_mod, f8_model, params, None,
                           trace[:F8_REQUESTS], prefill_chunk=chunk)
          for mode, chunk in (("chunked", SERVE_ENGINE["prefill_chunk"]),
                              ("blocking", 0))}
    same = sum(a == b for a, b in zip(f8["chunked"]["tokens"],
                                      f8["blocking"]["tokens"]))
    say(f"[softmax] f8 e4m3 KV pool: chunked tokens equal blocking's for "
        f"{same} of {F8_REQUESTS} requests")
    require(same == F8_REQUESTS, "f8 KV: chunked tokens differ from "
                                 "blocking's")

    longest = max((p for p, _ in trace), key=len)
    launches, captured, out, q, k, v = k9_on_lm_operands(
        torch, S, K, build_mod, model, params, longest, parity,
        f"{LM_ARCH} layer 0 bf16 prefill of {len(longest)} tokens")
    full = S.attn_full(q, k, v, cfg.resolved_head_dim ** -0.5, True)
    say(f"[softmax] K9 against the bf16 _attn_full (weights rounded to bf16 "
        f"before PV; information only): max abs diff "
        f"{float((out.float() - full.float()).abs().max()):.3e}")
    paths = {K9_PATH: (None, None, launches, captured)}
    chunked_vs_blocking(torch, model, params,
                        [p for p, _ in trace[:INFO_PROMPTS]],
                        f"{LM_ARCH} bf16 {cfg.n_layers} layers")

    for mode, res in results.items():
        st = res["stats"]
        say(f"[timing] softmax engine {mode}: decode tick p50 "
            f"{st['decode_tick_p50_s'] * 1e3:.3f} ms, p99 "
            f"{st['decode_tick_p99_s'] * 1e3:.3f} ms over "
            f"{st['decode_ticks']} ticks; prefill "
            f"{'chunk' if mode == 'chunked' else 'call'} p50 "
            f"{st['prefill_call_p50_s'] * 1e3:.3f} ms over "
            f"{st['prefill_calls']}; TTFT mean {st['ttft_mean_s']:.3f} s, "
            f"p50 {res['ttft_p50_s']:.3f} s; {st['tokens']} tokens in "
            f"{res['wall_s']:.3f} s wall ({st['tok_per_s']:.1f} tokens/s); "
            f"peak device memory {res['peak_gib']:.3f} GiB, "
            f"{res['peak_gib'] - res['base_gib']:.3f} GiB above the "
            f"{res['base_gib']:.3f} GiB allocated before the engine "
            f"[{card}]")
    profile_tick(torch, S, build_mod, model, params, "softmax")
    del params, results, f8, out, q, k, v, full
    torch.cuda.empty_cache()

    cfg4 = dataclasses.replace(cfg, n_layers=PARITY_LAYERS,
                               dtype=torch.float32)
    model4 = S.LM(cfg4)
    params4 = model4.init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    chunked_vs_blocking(torch, model4, params4, [p for p, _ in trace],
                        f"{LM_ARCH} {PARITY_LAYERS}-layer f32", tol=1e-4)
    launches4, captured4, out4, q4, k4, v4 = k9_on_lm_operands(
        torch, S, K, build_mod, model4, params4, longest, parity,
        f"{LM_ARCH} {PARITY_LAYERS}-layer f32 layer 0 prefill of "
        f"{len(longest)} tokens")
    paths[K9_F32_PATH] = (None, None, launches4, captured4)
    full4 = S.attn_full(q4, k4, v4, cfg.resolved_head_dim ** -0.5, True)
    err = float((out4 - full4).abs().max())
    require(torch.allclose(out4, full4, rtol=1e-5, atol=1e-5),
            f"K9 against _attn_full (f32): max abs err {err}")
    say(f"[softmax] K9 against _attn_full on the f32 variant's operands: max "
        f"abs err {err:.3e} (rtol = atol = 1e-5)")
    del params4, out4, q4, k4, v4, full4
    torch.cuda.empty_cache()

    kgen = torch.Generator(device=dev).manual_seed(9)
    parity_k9(torch, K, kgen, dev, parity)
    time_k9(torch, K, kgen, dev, parity, card)
    return paths


# --------------------------------------------------------------------- main
# ------------------------------------------------------------------ phase 9
LM_TRAIN_POLICIES = ("fused_dense+grad", "fused_packed+grad",
                     "reference+grad")
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128   # launch/train.py's defaults
LM_TRAIN_STEPS = 3


def lm_train_namespace():
    """The data, optimizer, trainer and example entry points the LM
    training phase drives."""
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.optim import (adamw_init, adamw_update,
                                   linear_warmup_cosine)
    from repro_torch.train import (make_grad_fn, make_train_step,
                                   train_state_init)
    from repro_torch.tree import tree_leaves, tree_map

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_spiking_qkformer_lm import make_kd_loss

    return types.SimpleNamespace(
        SyntheticTokenDataset=SyntheticTokenDataset, adamw_init=adamw_init,
        adamw_update=adamw_update, linear_warmup_cosine=linear_warmup_cosine,
        make_grad_fn=make_grad_fn, make_train_step=make_train_step,
        train_state_init=train_state_init, make_kd_loss=make_kd_loss,
        tree_leaves=tree_leaves, tree_map=tree_map)


class Parking:
    """Moves the tensors of captured launches between the card and host
    memory, storage by storage, so that views of one buffer stay views of
    one copy (a train's step and its earlier steps, a weight and its
    view): the LM training phase needs the card's memory that the earlier
    phases' captured launches hold until the timing phase replays them."""

    def __init__(self, torch):
        self.torch, self.memo = torch, {}

    def move(self, obj, dev):
        torch = self.torch
        if isinstance(obj, torch.Tensor):
            if obj.device.type == dev:
                return obj
            st = obj.untyped_storage()
            key = (st.data_ptr(), obj.device.type)
            new = self.memo.get(key)
            if new is None:
                raw = torch.empty(0, dtype=torch.uint8, device=obj.device)
                new = self.memo[key] = raw.set_(st).to(dev).untyped_storage()
            out = torch.empty(0, dtype=obj.dtype, device=dev)
            return out.set_(new, obj.storage_offset(), obj.size(),
                            obj.stride())
        if isinstance(obj, tuple):
            items = [self.move(v, dev) for v in obj]
            return (type(obj)(*items) if hasattr(obj, "_fields")
                    else tuple(items))
        if isinstance(obj, list):
            return [self.move(v, dev) for v in obj]
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return dataclasses.replace(obj, **{
                f.name: self.move(getattr(obj, f.name), dev)
                for f in dataclasses.fields(obj) if f.init})
        return obj

    def park(self, lists: list, dev: str) -> None:
        """Every list of captured launches in ``lists`` moved to ``dev``
        ("cpu" or "cuda") in place, so that each holder of a list sees the
        move."""
        for lst in lists:
            lst[:] = self.move(list(lst), dev)
        self.memo.clear()
        self.torch.cuda.synchronize()
        self.torch.cuda.empty_cache()


def lm_step_launches(build_mod, n_layers: int, policy: str) -> dict:
    """Launches of one LM training step (forward and backward) under
    ``policy``: per layer two fused PE passes, K3 on wo and its dx and dw,
    and under a packed policy two unpacks of the spikes to f32; none under
    the reference."""
    want = dict.fromkeys(build_mod.KERNELS, 0)
    if not policy.startswith("reference"):
        want.update(fused_pe=2 * n_layers, spike_matmul=n_layers,
                    spike_matmul_dx=n_layers, spike_matmul_dw=n_layers)
        if "packed" in policy:
            want["unpack_spikes"] = 2 * n_layers
    return want


def _leaf_names(tree, prefix: str = "") -> list:
    """The ``_leaves`` order's paths, as "blocks.3.attn.wq.w"."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [] if tree is None else [prefix[:-1]]


def host_available_gib() -> float:
    """MemAvailable of /proc/meminfo, in GiB (nan where it cannot be
    read)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2 ** 20
    except OSError:
        pass
    return math.nan


def rel_l2(torch, got, want) -> float:
    """||got - want|| / ||want|| in f64 (0 where both are zero)."""
    d = float(torch.linalg.vector_norm((got - want).double()))
    n = float(torch.linalg.vector_norm(want.double()))
    return d / n if n else (0.0 if d == 0 else math.inf)


def run_lm_policy(torch, S, T, build_mod, cfg, params_host, batches,
                  policy: str, parking, kept=None, against=None) -> dict:
    """``LM_TRAIN_STEPS`` steps of ``make_train_step`` under ``policy``
    from the host parameters ``params_host`` copied to the card: per step
    the launches (counts set to 0 just before the step and read just
    after), the loss, grad_norm, the per-layer spike totals and the
    host-clock time; the first step's launches captured (moved to host
    memory by ``parking`` until the timing phase); the peak memory of the
    later steps; then the forward alone (no autograd) for the forward /
    backward split. After each step, outside its time, the state it
    returned is held bit for bit: its AdamW first moments (the clipped
    gradient's image) and, after the last step, its parameters, copied to
    host memory into ``kept`` or compared with another run's copies
    ``against``."""
    model = S.LM(S.with_policy(cfg, policy))
    step = T.make_train_step(
        model, schedule=T.linear_warmup_cosine(3e-4, 10, LM_TRAIN_STEPS),
        clip_norm=1.0)
    dev = batches[0].device
    state = T.train_state_init(T.tree_map(
        lambda t: t.to(dev, non_blocking=True), params_host))
    out = {"launches": [], "loss": [], "grad_norm": [], "totals": [],
           "ms": [], "captured": None}
    for i, toks in enumerate(batches):
        torch.cuda.synchronize()
        build_mod.reset_launches()
        capture = (build_mod.capture_launches() if i == 0
                   else contextlib.nullcontext([]))
        t0 = time.perf_counter()
        with capture as captured, S.spike_log() as log:
            state, m = step(state, {"tokens": toks})
            torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(dict(build_mod.LAUNCHES))
        if i == 0:          # the peak of the steps timed, without the capture
            out["captured"] = captured
            if captured:
                parking.park([captured], "cpu")
            torch.cuda.reset_peak_memory_stats()
        held = T.tree_leaves(state.opt_state.m) + (
            T.tree_leaves(state.params) if i == len(batches) - 1 else [])
        if kept is not None:
            kept.append([t.to("cpu", copy=True) for t in held])
        if against is not None:
            bad = [j for j, (t, w) in enumerate(zip(held, against[i]))
                   if not torch.equal(t.to("cpu"), w)]
            require(len(held) == len(against[i]) and not bad,
                    f"{policy} step {i + 1}: state leaves {bad[:8]} (AdamW "
                    f"first moments, then parameters) differ from the kept "
                    f"run's")
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["totals"].append(S.spike_totals(log, cfg.n_layers))
        require(math.isfinite(out["loss"][-1])
                and math.isfinite(out["grad_norm"][-1]),
                f"{policy} step {i + 1}: loss {out['loss'][-1]}, grad_norm "
                f"{out['grad_norm'][-1]}")
        say(f"[lm train] {policy} step {i + 1}"
            f" ({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held): loss "
            f"{out['loss'][-1]:.6f}, grad_norm {out['grad_norm'][-1]:.6f}, "
            f"lr {float(m['lr']):.3e}, {out['ms'][-1]:.3f} ms; launches "
            f"{ {k: v for k, v in out['launches'][-1].items() if v} }")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.loss(state.params, {"tokens": batches[-1]})
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
    out["fwd_ms"] = statistics.median(fwd[1:])
    out["step"], out["state"] = step, state
    return out


def profile_lm_step(torch, run: dict, batch, step_ms: float) -> None:
    """``torch.profiler`` over one more step from the run's last state:
    device busy and idle share, the top device kernels."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = device_rows(torch, lambda: run["step"](run["state"],
                                                  {"tokens": batch}), 1)
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(r[0] for r in rows)
    if busy == 0:
        say("[profile] lm train: the profiler reported no device time; "
            "busy and idle not measured")
        return
    ours = sum(r[0] for r in rows if any(k in r[2] for k in HAND_WRITTEN))
    say(f"[profile] lm train fused_dense+grad step: device busy {busy:.3f} "
        f"ms of median {step_ms:.3f} ms (profiled step {wall:.3f} ms): idle "
        f"share {max(0.0, 1 - busy / step_ms):.3f}; "
        f"{sum(r[1] for r in rows)} device kernels; hand-written kernels "
        f"{ours:.3f} ms, everything else {busy - ours:.3f} ms")
    for ms, count, key in rows[:15]:
        say(f"[profile]   lm train {ms:8.4f} ms  x{count:<5d} {key[:100]}")


def lm_train_gates_f32(torch, S, T, K, build_mod, cfg, batch) -> None:
    """Step 1's gradient on the 4-layer f32 variant. Each fused policy
    against ``reference+grad``: loss within 1e-4 relative and per-layer
    spike totals within 0.1 % (its gradients' relative L2 printed: the
    reference's cuBLAS products sum in another order than the float-x
    tile, a few spikes flip at v_th, and the flips carry through the later
    layers). ``fused_dense+grad`` against the same step on the kernels'
    plain twins with their own sums (``chain_launchers``): the same loss
    and spike totals bit for bit, each gradient leaf within 1e-3 relative
    L2. Packed equal to dense bit for bit."""
    cfg4 = dataclasses.replace(cfg, n_layers=PARITY_LAYERS,
                               dtype=torch.float32)
    params4 = S.LM(cfg4).init(torch.Generator(device=batch.device)
                              .manual_seed(0), device=batch.device)
    runs = {}
    for policy in (*LM_TRAIN_POLICIES, "chain twins"):
        model = S.LM(S.with_policy(
            cfg4, "fused_dense+grad" if policy == "chain twins" else policy))
        build_mod.reset_launches()
        swap = (K.chain_launchers() if policy == "chain twins"
                else contextlib.nullcontext())
        with swap, S.spike_log() as log:
            loss, _, grads = T.make_grad_fn(model.loss)(params4,
                                                        {"tokens": batch})
            torch.cuda.synchronize()
        if policy != "chain twins":
            want = lm_step_launches(build_mod, PARITY_LAYERS, policy)
            require(dict(build_mod.LAUNCHES) == want,
                    f"f32 variant {policy}: launches "
                    f"{dict(build_mod.LAUNCHES)} != {want}")
        runs[policy] = (float(loss), T.tree_leaves(grads),
                        S.spike_totals(log, PARITY_LAYERS))
        names = _leaf_names(grads)

    def distance(a, b):
        (loss, grads, tot), (loss_r, grads_r, tot_r) = runs[a], runs[b]
        rel = abs(loss - loss_r) / abs(loss_r)
        whole = rel_l2(torch, torch.cat([g.flatten() for g in grads]),
                       torch.cat([r.flatten() for r in grads_r]))
        leaf = sorted(((rel_l2(torch, g, r), name) for g, r, name in
                       zip(grads, grads_r, names)), reverse=True)
        spikes = max(float(((tot[k].double() - t.double()).abs()
                            / t.double().clamp_min(1.0)).max())
                     for k, t in tot_r.items())
        diffs = {k: (tot[k] - t).tolist() for k, t in tot_r.items()}
        say(f"[lm train] {PARITY_LAYERS}-layer f32 {a} step 1 against {b}: "
            f"loss {loss:.7f} vs {loss_r:.7f} (rel {rel:.2e}); gradient rel "
            f"L2 {whole:.2e} (all {len(grads)} leaves together), worst "
            f"leaves " + ", ".join(f"{n} {e:.2e}" for e, n in leaf[:4])
            + f"; worst per-layer spike-total rel diff {spikes:.2e} "
            f"(differences per layer {diffs})")
        return rel, leaf[0][0], spikes

    for policy in ("fused_dense+grad", "fused_packed+grad"):
        rel, _, spikes = distance(policy, "reference+grad")
        require(rel <= 1e-4, f"f32 {policy}: loss rel diff {rel}")
        require(spikes <= 1e-3, f"f32 {policy}: spike totals {spikes}")
    rel, worst, spikes = distance("fused_dense+grad", "chain twins")
    require(rel == 0.0 and spikes == 0.0,
            f"f32 fused_dense+grad: loss or spike totals differ from the "
            f"chain twins' ({rel}, {spikes})")
    require(worst <= 1e-3, f"f32 fused_dense+grad: a gradient leaf {worst} "
                           f"from the chain twins'")
    d, p = runs["fused_dense+grad"], runs["fused_packed+grad"]
    require(d[0] == p[0] and all(torch.equal(a, b)
                                 for a, b in zip(d[1], p[1])),
            "f32 variant: fused_packed+grad not bit-equal to fused_dense")
    del params4, runs
    torch.cuda.empty_cache()


def phase_lm_train(torch, S, T, K, build_mod, dev, parking) -> tuple:
    """The spiking QKFormer LM trained at qwen3-1.7b's published width and
    depth (random weights from a CUDA ``torch.Generator`` seed 0): 3 steps
    of ``make_train_step`` (AdamW, clip 1.0, ``linear_warmup_cosine(3e-4,
    10, 3)``) on 8 x 129-token batches of ``SyntheticTokenDataset`` under
    each policy, packed bit-equal to dense; the f32 4-layer variant against
    the reference; one sequence-KD step from a frozen softmax teacher.
    Returns the two kernel paths' first steps for the timing phase, and
    the dense path's first loss and median step for phase 11."""
    cfg = S.get_config(LM_ARCH, spiking=True, attention_kind="qk_spiking")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    params = S.LM(cfg).init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    # kept in pinned host memory, so that no older state stays on the card
    # (the update holds two generations of parameters and AdamW moments)
    params_host = T.tree_map(lambda t: t.to("cpu").pin_memory(), params)
    del params
    ds = T.SyntheticTokenDataset(cfg.vocab_size, LM_TRAIN_SEQ + 1)
    batches = [torch.tensor(ds.batch(i, LM_TRAIN_BATCH), dtype=torch.int64,
                            device=dev) for i in range(LM_TRAIN_STEPS)]
    n_params = sum(t.numel() for t in T.tree_leaves(params_host))
    say(f"[lm train] {LM_ARCH} spiking qk_spiking: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{str(cfg.dtype)[6:]} activations, {n_params} f32 parameters, "
        f"init {time.perf_counter() - t0:.1f} s; batches "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ + 1} tokens "
        f"(SyntheticTokenDataset seed 0), {LM_TRAIN_STEPS} steps a policy; "
        f"{held:.3f} GiB on the card from earlier phases, "
        f"{host_available_gib():.1f} GiB of host memory available")
    runs, kept = {}, []
    for policy in LM_TRAIN_POLICIES:
        # the dense path's states kept on the host, the packed path's held
        # to them leaf by leaf
        runs[policy] = run = run_lm_policy(
            torch, S, T, build_mod, cfg, params_host, batches, policy,
            parking, kept=kept if policy == "fused_dense+grad" else None,
            against=kept if policy == "fused_packed+grad" else None)
        if policy == "fused_dense+grad":
            say(f"[lm train] host memory available after the dense run "
                f"(its states kept): {host_available_gib():.1f} GiB")
        want = lm_step_launches(build_mod, cfg.n_layers, policy)
        for i, launches in enumerate(run["launches"]):
            require(launches == want, f"{policy} step {i + 1}: launches "
                                      f"{launches} != {want}")
        if policy == "fused_packed+grad":
            d = runs["fused_dense+grad"]
            require(run["loss"] == d["loss"]
                    and run["grad_norm"] == d["grad_norm"],
                    f"fused_packed+grad losses {run['loss']} / grad norms "
                    f"{run['grad_norm']} differ from fused_dense+grad's")
            for a, b in zip(run["totals"], d["totals"]):
                for kind, t in b.items():
                    require(torch.equal(a[kind], t),
                            f"fused_packed+grad spike totals {kind} differ")
            say(f"[lm train] fused_packed+grad equals fused_dense+grad bit "
                f"for bit: losses, gradient norms, the per-layer spike "
                f"totals and every AdamW first-moment leaf of all "
                f"{LM_TRAIN_STEPS} steps, and every parameter leaf after "
                f"the last")
            kept.clear()
        med = statistics.median(run["ms"][1:])
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        say(f"[timing] lm train {policy}: step median {med:.3f} ms over "
            f"steps 2-{LM_TRAIN_STEPS} (step 1 {run['ms'][0]:.3f}); "
            f"{tokens / med * 1e3:.1f} tokens/s; forward {run['fwd_ms']:.3f}"
            f" ms, backward and update {max(med - run['fwd_ms'], 0.0):.3f} "
            f"ms; peak memory {run['peak_gib']:.3f} GiB; spikes a step q "
            f"{int(run['totals'][0]['q'].sum())}, attn "
            f"{int(run['totals'][0]['attn'].sum())}, mlp "
            f"{int(run['totals'][0]['mlp'].sum())}")
        run["median_ms"] = med
        if policy == "fused_dense+grad":
            profile_lm_step(torch, run, batches[-1], med)
        del run["state"], run["step"]
        torch.cuda.empty_cache()
    ref = runs["reference+grad"]["median_ms"]
    for policy in LM_TRAIN_POLICIES[:2]:
        say(f"[timing] lm train {policy} step against reference+grad: "
            f"{runs[policy]['median_ms']:.3f} / {ref:.3f} ms "
            f"({ref / runs[policy]['median_ms']:.2f}x)")
    lm_train_gates_f32(torch, S, T, K, build_mod, cfg, batches[0])

    # one sequence-KD step of the spiking student (fused_dense+grad) from a
    # frozen softmax teacher, as examples/torch_spiking_qkformer_lm.py runs
    teacher = S.LM(S.get_config(LM_ARCH))
    tparams = teacher.init(torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    student = S.LM(S.with_policy(cfg, "fused_dense+grad"))
    grad_fn = T.make_grad_fn(T.make_kd_loss(student, teacher, tparams))
    params = T.tree_map(lambda t: t.to(dev, non_blocking=True), params_host)
    opt = T.adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    loss, m, grads = grad_fn(params, {"tokens": batches[0]})
    del grad_fn, tparams             # the frozen teacher is done
    new_p, _ = T.adamw_update(grads, opt, params, lr=1e-3)
    torch.cuda.synchronize()
    kd_ms = (time.perf_counter() - t0) * 1e3
    want = lm_step_launches(build_mod, cfg.n_layers, "fused_dense+grad")
    require(dict(build_mod.LAUNCHES) == want,
            f"KD step launches {dict(build_mod.LAUNCHES)} != {want}")
    vals = [float(loss), float(m["ce"]), float(m["kl"])]
    require(all(math.isfinite(v) for v in vals)
            and all(bool(torch.isfinite(p).all())
                    for p in T.tree_leaves(new_p)),
            f"KD step: loss, ce, kl {vals} or the updated parameters are "
            f"not finite")
    say(f"[lm train] sequence-KD step (KDConfig(alpha=0.5, temperature=2.0),"
        f" frozen softmax {LM_ARCH} teacher, fused_dense+grad student): "
        f"loss {vals[0]:.6f} (ce {vals[1]:.6f}, kl {vals[2]:.6f}); "
        f"{kd_ms:.3f} ms with the AdamW update; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; launches "
        f"equal a training step's")
    del teacher, student, opt, grads, new_p, params, params_host
    torch.cuda.empty_cache()
    dense = runs["fused_dense+grad"]
    return {LM_TRAIN_PATH.format(policy): (
        None, None, runs[policy]["launches"][0],
        grouped_kv(cfg, runs[policy]["captured"]))
        for policy in LM_TRAIN_POLICIES[:2]}, {
            "first_loss": dense["loss"][0], "median_ms": dense["median_ms"]}


# ----------------------------------------------------------------- phase 10
FAMILY_REQUESTS = 8           # requests of each family's trace
FAMILY_MAX_NEW = 16           # tokens each generates, greedy
SPIKING_QK = dict(spiking=True, attention_kind="qk_spiking")
VLM_IMAGES = (4, 1024, 1024)  # phi-3-vision's CLIP patches: B, N, d_vision
VLM_TEXT = 64
VLM_DECODES = 16
ENCDEC_FRAMES = (4, 256, 1024)  # seamless's audio frames: B, S_src, d_src
ENCDEC_TARGET = 16
ENCDEC_DECODES = 32
CONTINUATION = (4, 200)       # B, S of the continuation gate's sequences
# the f32 precision variants' depth: 4 layers; zamba2 keeps one whole
# group of its attn_every mamba layers under its shared attention site
FAMILY_PARITY_LAYERS = {"zamba2-7b": 9}


def family_trace(vocab: int) -> list:
    """A family's serving trace: (prompt, max_new) per request, greedy,
    from ``numpy.random.default_rng(0)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, int(rng.integers(
        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))).astype(np.int32),
        FAMILY_MAX_NEW) for _ in range(FAMILY_REQUESTS)]


def family_params(torch, S, cfg, dev) -> tuple:
    """``build_model(cfg).init`` on the card's generator, seed 0; the
    parameters and their count."""
    params = S.build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    return params, sum(t.numel() for t in S.tree_leaves(params))


def family_line(torch, card: str, label: str, n_params: int, cfg,
                res: Optional[dict], tick: tuple, prefill_ms=None,
                decode=None) -> None:
    """One config's line: parameters, peak memory, prefill, the decode
    tick's p50 / p99, tokens/s, a bare tick's device busy and idle."""
    gb = n_params * torch.empty((), dtype=cfg.param_dtype).element_size()
    if res is not None:
        st = res["stats"]
        prefill_ms = st["prefill_call_p50_s"] * 1e3
        p50, p99 = (st["decode_tick_p50_s"] * 1e3,
                    st["decode_tick_p99_s"] * 1e3)
        tps, peak = st["tok_per_s"], res["peak_gib"]
        where = (f"engine {st['prefill_mode']} over {st['decode_ticks']} "
                 f"ticks and {st['prefill_calls']} prefill calls; "
                 f"{res['base_gib']:.3f} GiB allocated before it")
    else:
        p50, p99, tps, peak = decode
        where = "direct prefill / decode_step"
    med, busy = tick
    say(f"[families] {label}: {n_params} parameters ({gb / 1e9:.2f} GB "
        f"{str(cfg.param_dtype)[6:]}); peak device memory {peak:.3f} GiB; "
        f"prefill p50 {prefill_ms:.3f} ms; decode tick p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms ({where}); {tps:.1f} tokens/s; a bare tick "
        f"{med:.3f} ms, device busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / med):.3f}")
        + f" [{card}]")


def engine_gate(torch, S, build_mod, model, params, trace, label: str,
                policy=None, chunk=None) -> dict:
    """The trace through the engine (the serve phase's 16 slots, 512 rows,
    64-token chunks) against a direct loop at its shapes: tokens equal.
    Returns the engine's run."""
    kw = {} if chunk is None else {"prefill_chunk": chunk}
    res = run_engine(torch, S, build_mod, model, params, policy, trace, **kw)
    st = res["stats"]
    tokens = pool_direct_loop(torch, S, model, params, trace,
                              chunked=st["prefill_mode"] == "chunked")
    same = sum(a == b for a, b in zip(tokens, res["tokens"]))
    say(f"[families] {label} engine ({st['prefill_mode']}, "
        f"{st['prefill_calls']} prefill calls, {st['decode_ticks']} decode "
        f"ticks): tokens equal to the direct loop for {same} of "
        f"{len(trace)} requests; launches "
        f"{ {k: v for k, v in res['launches'].items() if v} }")
    require(same == len(trace), f"{label}: engine tokens differ from the "
                                f"direct loop")
    return res


def continuation_gate(torch, S, cfg, dev, label: str,
                      prompts=None) -> None:
    """The f32 variant's decode equals the continuation of a longer
    prefill (rtol = atol = 2e-3): prefill of S - 1 tokens then one
    decode_step against the last position of a prefill of S. With
    ``prompts`` also its chunked prefill against the blocking one (rtol =
    atol = 1e-4, greedy tokens equal)."""
    params, _ = family_params(torch, S, cfg, dev)
    model = S.build_model(cfg)
    if prompts is not None:
        chunked_vs_blocking(torch, model, params, prompts, label, tol=1e-4)
    b, s = CONTINUATION
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=gen)
    if cfg.family == "encdec":
        src = torch.randn((b, ENCDEC_FRAMES[1], cfg.d_src), device=dev,
                          generator=gen)
        full, _ = model.prefill(params, {"src_embeds": src,
                                         "tgt_tokens": toks})
        _, cache = model.prefill(params, {"src_embeds": src,
                                          "tgt_tokens": toks[:, :-1]},
                                 max_len=s)
    else:
        full, _ = model.prefill(params, {"tokens": toks})
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                 max_len=s)
    dec, _ = model.decode_step(params, toks[:, -1:], cache)
    err = float((dec - full).abs().max())
    require(bool(torch.isfinite(dec).all()), f"{label}: non-finite logits")
    require(torch.allclose(dec, full, rtol=2e-3, atol=2e-3),
            f"{label}: decode differs from the prefill continuation by "
            f"{err}")
    say(f"[families] {label}: decode of token {s} equal to the prefill "
        f"continuation at rtol = atol = 2e-3 (largest difference "
        f"{err:.3e}, {b} sequences)")
    del params, cache
    torch.cuda.empty_cache()


def parity_variant(torch, cfg, arch: str):
    """The config's f32 precision variant: f32 activations and parameters,
    full width, ``PARITY_LAYERS`` layers (an encoder's too) or
    ``FAMILY_PARITY_LAYERS``."""
    return dataclasses.replace(
        cfg, n_layers=FAMILY_PARITY_LAYERS.get(arch, PARITY_LAYERS),
        n_enc_layers=PARITY_LAYERS if cfg.n_enc_layers else 0,
        dtype=torch.float32, param_dtype=torch.float32)


def spiking_policy_gates(torch, S, cfg, dev, arch: str, trace,
                         tokens) -> None:
    """The f32 variant (full width, ``PARITY_LAYERS`` layers) teacher-forced
    over the trace's sequences under each policy: fused_dense and
    fused_packed spike totals within 0.1 % of the reference's, top-1
    agreement at least 0.99."""
    cfg4 = parity_variant(torch, cfg, arch)
    params4, _ = family_params(torch, S, cfg4, dev)
    seqs = [list(p) + out for (p, _), out in zip(trace, tokens)]
    runs = {policy: teacher_forced(torch, S, S.LM(S.with_policy(cfg4,
                                                                 policy)),
                                   params4, seqs)
            for policy in SERVE_POLICIES}
    for policy in ("fused_dense", "fused_packed"):
        agreement(torch, f"{arch} {cfg4.n_layers}-layer f32 {policy} vs "
                  f"reference", runs[policy], runs["reference"], 1e-3)
    del params4, runs
    torch.cuda.empty_cache()


def phase_families(torch, S, K, build_mod, dev) -> dict:
    """The other LM families at their published widths and depths on
    random weights from seed 0, through ``build_model``, ``init`` on the
    card's generator and the engine (or the model's own calls): the
    spiking QKFormer olmoe-1b-7b under the three policies and olmoe as
    published, mamba2-130m and zamba2-7b (chunked and blocking), the
    spiking phi-3-vision-4.2b (image + text prefill and decode, then the
    engine on text), seamless-m4t-large-v2 (frames + target prefill and
    decode); each gated, timed and profiled, and the f32 variants held to
    their gates. Returns the olmoe and phi-3 decode ticks' K2 / K3
    launches for the timing phase's rows."""
    card = gpu_name_and_power()
    paths = {}
    want_none = dict.fromkeys(build_mod.KERNELS, 0)
    t_phase = time.perf_counter()

    def start(arch, **over):
        cfg = S.get_config(arch, **over)
        t0 = time.perf_counter()
        params, n = family_params(torch, S, cfg, dev)
        say(f"[families] {arch}{' spiking qk_spiking' if over else ''}: "
            f"{cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{str(cfg.dtype)[6:]} activations, {n} parameters; init "
            f"{time.perf_counter() - t0:.1f} s, {t0 - t_phase:.1f} s into "
            f"the phase [{card}]")
        return cfg, params, n, family_trace(cfg.vocab_size)

    # -- olmoe-1b-7b, spiking qk_spiking: the three policies
    arch = "olmoe-1b-7b"
    cfg, params, n, trace = start(arch, **SPIKING_QK)
    want = tick_launches(build_mod, cfg.n_layers)
    runs = {}
    for policy in SERVE_POLICIES:
        model = S.LM(S.with_policy(cfg, policy))
        res = runs[policy] = engine_gate(torch, S, build_mod, model, params,
                                         trace, f"{arch} spiking {policy}",
                                         policy=policy)
        st = res["stats"]
        calls = 0 if policy == "reference" else (st["decode_ticks"]
                                                 + st["prefill_calls"])
        require(res["launches"] == {k: v * calls for k, v in want.items()},
                f"{arch} {policy}: launches {res['launches']}")
        if policy == "fused_dense":
            launches, captured, _ = capture_tick(torch, S, build_mod, model,
                                                 params, "decode")
            require(launches == want, f"{arch} decode tick launches "
                                      f"{launches}")
            paths[FAMILY_PATH.format(arch)] = (
                None, None, launches, grouped_kv(cfg, captured))
            say(f"[families] {arch} spiking fused_dense: one decode tick "
                f"launches {launches['fused_pe']} fused_pe and "
                f"{launches['spike_matmul']} spike_matmul")
        family_line(torch, card, f"{arch} spiking {policy}", n, cfg, res,
                    profile_tick(torch, S, build_mod, model, params,
                                 f"{arch} {policy}", top=4))
    require(runs["fused_packed"]["tokens"] == runs["fused_dense"]["tokens"],
            f"{arch}: fused_packed tokens differ from fused_dense's")
    say(f"[families] {arch} spiking: fused_packed tokens equal "
        f"fused_dense's")
    del params
    torch.cuda.empty_cache()
    spiking_policy_gates(torch, S, cfg, dev, arch, trace,
                         runs["fused_dense"]["tokens"])

    # -- olmoe-1b-7b as published (softmax attention, the MoE FFN)
    cfg, params, n, trace = start(arch)
    model = S.LM(cfg)
    res = engine_gate(torch, S, build_mod, model, params, trace,
                      f"{arch} as published")
    require(res["launches"] == want_none, f"{arch}: a kernel launched")
    family_line(torch, card, f"{arch} as published", n, cfg, res,
                profile_tick(torch, S, build_mod, model, params, arch,
                             top=4))
    del params, model
    torch.cuda.empty_cache()

    # -- mamba2-130m and zamba2-7b: chunked (on ssm_chunk) and blocking
    for arch in ("mamba2-130m", "zamba2-7b"):
        cfg, params, n, trace = start(arch)
        model = S.LM(cfg)
        res = {mode: engine_gate(torch, S, build_mod, model, params, trace,
                                 f"{arch} {mode}", chunk=chunk)
               for mode, chunk in (("chunked", SERVE_ENGINE["prefill_chunk"]),
                                   ("blocking", 0))}
        same = sum(a == b for a, b in zip(res["chunked"]["tokens"],
                                          res["blocking"]["tokens"]))
        say(f"[families] {arch}: chunked prefill (chunks of "
            f"{SERVE_ENGINE['prefill_chunk']} rounded up to ssm_chunk "
            f"{cfg.ssm_chunk}) tokens equal blocking's for {same} of "
            f"{len(trace)} requests at bf16 (information: cuBLAS sums a "
            f"chunk's rows in another order; the gate is the f32 "
            f"variant's)")
        tick = profile_tick(torch, S, build_mod, model, params, arch, top=4)
        for mode in res:
            family_line(torch, card, f"{arch} {mode}", n, cfg, res[mode],
                        tick)
        del params, model, res
        torch.cuda.empty_cache()
        continuation_gate(torch, S, parity_variant(torch, cfg, arch), dev,
                          f"{arch} f32 {FAMILY_PARITY_LAYERS.get(arch, 4)} "
                          f"layers", prompts=[p for p, _ in trace])

    # -- phi-3-vision-4.2b, spiking qk_spiking: image + text, then text
    arch = "phi-3-vision-4.2b"
    cfg, params, n, trace = start(arch, **SPIKING_QK)
    model = S.LM(S.with_policy(cfg, "fused_dense"))
    gen = torch.Generator(device=dev).manual_seed(1)
    img = torch.randn(VLM_IMAGES, device=dev, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (VLM_IMAGES[0], VLM_TEXT),
                         device=dev, generator=gen)
    n_img = cfg.n_img_tokens // cfg.vision_pool_window ** 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": toks,
                                           "img_embeds": img},
                                  max_len=n_img + VLM_TEXT + VLM_DECODES)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    require(int(cache["len"]) == n_img + VLM_TEXT,
            f"{arch}: cache len {int(cache['len'])}")
    ticks = []
    for _ in range(VLM_DECODES):
        require(bool(torch.isfinite(logits).all()), f"{arch}: non-finite")
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, logits.argmax(-1)[:, None],
                                          cache)
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
    require(int(cache["len"]) == n_img + VLM_TEXT + VLM_DECODES,
            f"{arch}: cache len {int(cache['len'])} after the decodes")
    say(f"[families] {arch}: prefill of {VLM_IMAGES[1]} patches (merged "
        f"to {n_img}) and {VLM_TEXT} text tokens x {VLM_IMAGES[0]}, then "
        f"{VLM_DECODES} decode_steps: logits finite, cache len "
        f"{int(cache['len'])}")
    ticks.sort()
    tick = profile_tick(torch, S, build_mod, model, params, arch, top=4)
    family_line(torch, card, f"{arch} spiking fused_dense image + text", n,
                cfg, None, tick, prefill_ms=prefill_ms,
                decode=(statistics.median(ticks), ticks[-1],
                        VLM_IMAGES[0] / statistics.median(ticks) * 1e3,
                        torch.cuda.max_memory_allocated() / 2 ** 30))
    del cache, logits
    res = engine_gate(torch, S, build_mod, model, params, trace,
                      f"{arch} spiking fused_dense text", policy="fused_dense")
    launches, captured, _ = capture_tick(torch, S, build_mod, model, params,
                                         "decode")
    require(launches == tick_launches(build_mod, cfg.n_layers),
            f"{arch} decode tick launches {launches}")
    paths[FAMILY_PATH.format(arch)] = (None, None, launches,
                                       grouped_kv(cfg, captured))
    family_line(torch, card, f"{arch} spiking fused_dense text", n, cfg, res,
                tick)
    del params, model
    torch.cuda.empty_cache()
    spiking_policy_gates(torch, S, cfg, dev, arch, trace, res["tokens"])

    # -- seamless-m4t-large-v2: frames + target prefill, then decode
    arch = "seamless-m4t-large-v2"
    cfg, params, n, _ = start(arch)
    model = S.build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    src = torch.randn(ENCDEC_FRAMES, device=dev, generator=gen)
    tgt = torch.randint(0, cfg.vocab_size, (ENCDEC_FRAMES[0], ENCDEC_TARGET),
                        device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"src_embeds": src,
                                           "tgt_tokens": tgt},
                                  max_len=ENCDEC_TARGET + ENCDEC_DECODES)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    src_len = cache["layers"]["cross"][0].shape[2]
    ticks = []
    for _ in range(ENCDEC_DECODES):
        require(bool(torch.isfinite(logits).all()), f"{arch}: non-finite")
        tok = logits.argmax(-1)[:, None]
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
    require(int(cache["len"]) == ENCDEC_TARGET + ENCDEC_DECODES,
            f"{arch}: cache len {int(cache['len'])}")
    say(f"[families] {arch}: prefill of {ENCDEC_FRAMES[1]} frames (pooled "
        f"to {src_len}) and a {ENCDEC_TARGET}-token target x "
        f"{ENCDEC_FRAMES[0]}, then {ENCDEC_DECODES} decode_steps: logits "
        f"finite, cache len {int(cache['len'])}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = device_rows(torch, lambda: model.decode_step(params, tok, cache),
                       3)
    ticks.sort()
    med = statistics.median(ticks)
    busy = sum(r[0] for r in rows) or None
    family_line(torch, card, f"{arch} as published", n, cfg, None,
                (med, busy), prefill_ms=prefill_ms,
                decode=(med, ticks[-1], ENCDEC_FRAMES[0] / med * 1e3, peak))
    del params, cache, logits, model
    torch.cuda.empty_cache()
    continuation_gate(torch, S, parity_variant(torch, cfg, arch), dev,
                      f"{arch} f32 {PARITY_LAYERS} + {PARITY_LAYERS} layers")
    return paths


# ----------------------------------------------------------------- phase 11
DRIVER_ARGS = ["--arch", LM_ARCH, "--spiking", "--qk-attention", "--policy",
               "fused_dense", "--batch", str(LM_TRAIN_BATCH), "--seq",
               str(LM_TRAIN_SEQ)]
DRIVER_STEPS = 4
COMPRESS_STEPS = 3


@contextlib.contextmanager
def timed_checkpoints(rec: dict):
    """Record, around the elastic runner's checkpoint calls, the host copy
    of a save (on the caller's thread), its write (the writer thread:
    CRC32s, ``.npy`` files, the rename) and each restore, in seconds."""
    import repro_torch.train.checkpoint as ck
    import repro_torch.train.elastic as el

    def wrap(mod, name):
        fn = getattr(mod, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            rec.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        setattr(mod, name, timed)
        return fn

    saved = [(ck, n, wrap(ck, n)) for n in ("_flatten_host", "_write")]
    saved.append((el, "restore_checkpoint", wrap(el, "restore_checkpoint")))
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def driver_run(torch, build_mod, argv: list, steps: int) -> tuple:
    """``launch.train.main(argv)`` with the launch counts set to 0 just
    before and read just after; each kernel of the LM step launched its
    count a step, ``steps`` times."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    torch.cuda.synchronize()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    run = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = dict(build_mod.LAUNCHES)
    want = {k: v * steps for k, v in lm_step_launches(
        build_mod, get_config(LM_ARCH).n_layers, "fused_dense+grad").items()}
    require(got == want, f"driver {' '.join(argv[-6:])}: launches {got} != "
                         f"{want}")
    require(not torch.distributed.is_initialized(),
            "the driver left a process group behind")
    return run, seconds, {k: v for k, v in got.items() if v}


def dp_ab(torch, model, batch, mesh, smi: str) -> None:
    """The step's data-parallel all-reduce by itself: ``make_train_step``
    with and without the world's group (NCCL, one rank), alternating on
    one state after a step of warm-up, each step waited for; and the
    loader's host work for one batch."""
    from repro_torch.data import ShardedLoader, SyntheticTokenDataset
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.train import make_train_step, train_state_init

    dev = batch["tokens"].device
    sched = linear_warmup_cosine(3e-4, 10, 8)
    world = mesh.make_test_mesh((1,), ("data",))
    steps = {"plain": make_train_step(model, schedule=sched),
             "dp": make_train_step(model, schedule=sched,
                                   dp_group=world.get_group("data"))}
    state = train_state_init(model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    ms = {"plain": [], "dp": []}
    for name in ("dp", "plain", "dp", "dp", "plain", "plain", "dp"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps[name](state, batch)
        m["loss"].item()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    del state, m
    ds = SyntheticTokenDataset(model.cfg.vocab_size, LM_TRAIN_SEQ + 1)
    loader = ShardedLoader(lambda st, bs, sh, n: {"tokens": ds.batch(
        st, bs, sh, n)}, LM_TRAIN_BATCH, world)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in range(5):
        loader(st)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) / 5 * 1e3
    say(f"[timing] driver A/B {smi}: make_train_step without the group "
        f"{[round(t, 3) for t in ms['plain']]} ms (median "
        f"{statistics.median(ms['plain']):.3f}), with the all-reduce over it "
        f"{[round(t, 3) for t in ms['dp'][1:]]} (median "
        f"{statistics.median(ms['dp'][1:]):.3f}; the first, "
        f"{ms['dp'][0]:.3f}, a warm-up); ShardedLoader {load_ms:.3f} ms a "
        f"batch")


def phase_driver(torch, build_mod, dev, smi: str, lm_dense: dict) -> None:
    """The training entry point at qwen3-1.7b's full width and depth:
    checkpoint, failure, restore and remesh bit-equal to the uninterrupted
    run; the compressed path; see the module docstring (phase 11)."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch import mesh
    from repro_torch.optim import (compress_int8, constant_lr,
                                   decompress_int8, error_feedback_init)
    from repro_torch.train import (make_compressed_train_step, make_grad_fn,
                                   train_state_init)
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    root = ROOT / "build" / "driver_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    say(f"[driver] {smi}: {free / 1e9:.1f} GB free on the checkpoint's disk "
        f"({root}) before the save")
    try:
        # the run with the failure first: its save's host copy is gone
        # when its final state is kept in host memory
        rec: dict = {}
        with timed_checkpoints(rec):
            cut, cut_s, launches = driver_run(
                torch, build_mod, DRIVER_ARGS + [
                    "--steps", str(DRIVER_STEPS), "--ckpt-every", "2",
                    "--simulate-failure", "3", "--ckpt-dir",
                    str(root / "cut")], DRIVER_STEPS)
        events = [{k: v for k, v in e.items() if k != "path"}
                  for e in cut.events]
        want = [{"kind": "checkpoint", "step": 2},
                {"kind": "failure", "step": 3},
                {"kind": "restore", "step": 2},
                {"kind": "remesh", "mesh": {"data": 1}, "resume_step": 3}]
        require(events == want, f"driver events {events} != {want}")
        ckpt = root / "cut" / "step_00000002"
        nbytes = sum(f.stat().st_size for f in ckpt.glob("*.npy"))
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(cut.state))
        copy_s, write_s = rec["_flatten_host"][0], rec["_write"][0]
        restore_s = rec["restore_checkpoint"][0]
        say(f"[driver] {smi}: events {events}; the checkpoint "
            f"{nbytes / 1e9:.3f} GB in {len(list(ckpt.glob('*.npy')))} "
            f".npy files ({state_bytes / 1e9:.3f} GB of state); save "
            f"{copy_s + write_s:.2f} s ({nbytes / 1e9 / (copy_s + write_s):.3f}"
            f" GB/s: host copy {copy_s:.2f} s on the caller's thread, write "
            f"with CRC32s {write_s:.2f} s), restore with CRC32 checks "
            f"{restore_s:.2f} s ({nbytes / 1e9 / restore_s:.3f} GB/s); run "
            f"{cut_s:.1f} s; launches {launches}")
        require(cut.losses[0] == lm_dense["first_loss"],
                f"driver step 0 loss {cut.losses[0]!r} != phase 9's "
                f"{lm_dense['first_loss']!r}")
        kept = [t.to("cpu") for t in tree_leaves(cut.state)]
        cut_losses, cut_ms = cut.losses, cut.step_ms
        del cut
        torch.cuda.empty_cache()

        whole, whole_s, launches = driver_run(
            torch, build_mod, DRIVER_ARGS + [
                "--steps", str(DRIVER_STEPS), "--ckpt-every", "100",
                "--ckpt-dir", str(root / "whole")], DRIVER_STEPS)
        require(whole.events == [], f"uninterrupted events {whole.events}")
        require(cut_losses == whole.losses,
                f"driver losses with the failure {cut_losses} != "
                f"uninterrupted {whole.losses}")
        leaves = tree_leaves(whole.state)
        bad = [i for i, (t, k) in enumerate(zip(leaves, kept))
               if not torch.equal(t, k.to(dev))]
        require(len(leaves) == len(kept) and not bad,
                f"driver final state leaves {bad[:8]} differ after the "
                f"checkpoint round trip")
        med = statistics.median(whole.step_ms[1:])
        say(f"[driver] {smi}: step 0 loss {whole.losses[0]!r} equals phase "
            f"9's first fused_dense+grad loss; losses {whole.losses} and all "
            f"{len(leaves)} leaves of the final parameters and AdamW moments "
            f"bit-equal with and without the failure")
        say(f"[timing] driver {smi}: step median {med:.3f} ms over steps 2-"
            f"{DRIVER_STEPS} (steps {[round(t, 3) for t in whole.step_ms]} "
            f"ms; with the failure {[round(t, 3) for t in cut_ms]}) against "
            f"phase 9's make_train_step {lm_dense['median_ms']:.3f} ms; "
            f"{LM_TRAIN_BATCH * LM_TRAIN_SEQ / med * 1e3:.1f} tokens/s; "
            f"run {whole_s:.1f} s; launches {launches}")
        whole_losses, whole_ms = whole.losses, whole.step_ms
        del whole, leaves, kept
        torch.cuda.empty_cache()

        comp, comp_s, launches = driver_run(
            torch, build_mod, DRIVER_ARGS + [
                "--steps", str(COMPRESS_STEPS), "--compress"],
            COMPRESS_STEPS)
        require(comp.losses[0] == whole_losses[0],
                f"compressed step 0 loss {comp.losses[0]!r} != "
                f"{whole_losses[0]!r}")
        require(all(math.isfinite(v) for v in comp.losses)
                and abs(comp.losses[2] - whole_losses[2]) <= 0.5,
                f"compressed losses {comp.losses} against {whole_losses}")
        say(f"[timing] driver --compress {smi}: losses {comp.losses} "
            f"(uncompressed {whole_losses[:COMPRESS_STEPS]}); steps "
            f"{[round(t, 3) for t in comp.step_ms]} ms against uncompressed "
            f"{[round(t, 3) for t in whole_ms[:COMPRESS_STEPS]]}; run "
            f"{comp_s:.1f} s; launches {launches}")
        del comp
        torch.cuda.empty_cache()

        # the residual of one leaf after one compressed step, against the
        # first step's gradient
        cfg = get_config(LM_ARCH, spiking=True, attention_kind="qk_spiking",
                         policy="fused_dense+grad")
        model = build_model(cfg)
        ds = SyntheticTokenDataset(cfg.vocab_size, LM_TRAIN_SEQ + 1)
        batch = {"tokens": torch.from_numpy(ds.batch(0, LM_TRAIN_BATCH)).to(
            dev)}
        made = mesh.init_distributed(dev)
        try:
            dp_ab(torch, model, batch, mesh, smi)
            params = model.init(torch.Generator(device=dev).manual_seed(0),
                                device=dev)
            _, _, g = make_grad_fn(model.loss)(params, batch)
            g_emb = g["embed"]["emb"]
            del g
            step = make_compressed_train_step(
                model, mesh.make_test_mesh((1,), ("data",)),
                schedule=constant_lr(3e-4))
            (state, err), _ = step((train_state_init(params),
                                    error_feedback_init(params)), batch)
            del params, state
            want = g_emb - decompress_int8(*compress_int8(g_emb))
            require(torch.equal(err["embed"]["emb"], want),
                    "compressed residual of embed.emb != g - "
                    "decompress(compress(g))")
            say(f"[driver] {smi}: the compressed step's residual of "
                f"embed.emb ({g_emb.numel()} values) equals g - "
                f"decompress(compress(g)) of the first step's gradient bit "
                f"for bit")
            del err, want, g_emb
        finally:
            if made:
                mesh.shutdown_distributed()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not torch.distributed.is_initialized(),
            "a process group was left behind")
    say(f"[driver] {smi}: phase {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- phase 12
KD_STEPS = 220            # the pipeline's default budget (teacher and KDT)
KD_POLICY = "fused_dense"
KD_AGREEMENT = 0.99       # top-1 agreement of the W2TTFS and AP heads


def kd_pipeline_module():
    """``examples/torch_train_kd_cifar.py``, the pipeline a user runs."""
    import importlib.util

    path = ROOT / "examples" / "torch_train_kd_cifar.py"
    spec = importlib.util.spec_from_file_location("torch_train_kd_cifar",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kd_first_step_gate(torch, M, build_mod, P, rec: dict, dev) -> None:
    """KDT's first step under the kernels against the same step on the
    launchers' plain versions (and, for information, reference+grad), its
    launches against the layer list, and the profiler's breakdown of the
    step beside the pipeline's median KDT step."""
    cfg = rec["cfg"]["KDT"]
    params, state = rec["init"]
    _, tparams, tstate, tcfg = rec["teacher"]
    tvar = {"params": tparams, "state": tstate}
    variables = {"params": params, "state": state}
    batch = [P._batch(P._dataset(), 0, P.BATCH, dev)]
    kernels = TrainPath(torch, M, cfg, variables, tcfg, tvar, "unfused",
                        f"{KD_POLICY}+grad", suffix=" (KDT)")
    kernels.run(batch, build_mod)
    plain = TrainPath(torch, M, cfg, variables, tcfg, tvar, "unfused",
                      f"{KD_POLICY}+grad", suffix=" (KDT, plain versions)")
    with plain_launchers():
        plain.run(batch, build_mod)
    compare_training(kernels, plain)
    profile_step(torch, kernels, statistics.median(rec["step_ms"]["KDT"]))
    ref = TrainPath(torch, M, cfg, variables, tcfg, tvar, "unfused",
                    "reference+grad", suffix=" (KDT)")
    ref.run(batch, build_mod)
    rel_loss, errs, worst_spikes = training_distance(kernels, ref)
    say(f"[kd pipeline] for information, {kernels.name} vs {ref.name} step "
        f"1: loss rel diff {rel_loss:.3e}; gradient leaves past 1e-3: "
        f"{sum(e > 1e-3 for e in errs)} of {len(errs)}; worst spike total "
        f"rel diff {worst_spikes:.3e}")
    want = unfused_step_launches(cfg, M.snn_cnn)
    want["w2ttfs_pool"] = int(cfg.head == "w2ttfs")
    got = kernels.launches[0]
    say(f"[kd pipeline] launches of one KDT step: {got}")
    require(got == want, f"KDT step launches {got} != {want}")


def kd_head_gate(torch, P, rec: dict, dev) -> None:
    """The W2TTFS head against the AP head on the KD-QAT weights over the
    evaluation images."""
    params, state = rec["vars"]["KD-QAT"]
    ds = P._dataset()
    agree = total = 0
    worst = 0.0
    with torch.no_grad():
        for i in range(P.EVAL_BATCHES):
            x = P._batch(ds, 10_000 + i, 128, dev)["images"]
            logits = [P.snn_cnn.forward({"params": params, "state": state},
                                        x, rec["cfg"][stage], train=False,
                                        policy=KD_POLICY)[0]
                      for stage in ("KD-QAT", "W2TTFS")]
            agree += int((logits[0].argmax(-1) == logits[1].argmax(-1))
                         .sum())
            total += x.shape[0]
            worst = max(worst, float((logits[0] - logits[1]).abs().max()))
    say(f"[kd pipeline] W2TTFS vs AP head on the KD-QAT weights, {total} "
        f"images: top-1 agreement {agree / total:.4f} (gate "
        f"{KD_AGREEMENT}); worst logit difference {worst:.3e}")
    require(agree / total >= KD_AGREEMENT,
            f"W2TTFS and AP heads agree on {agree} of {total} images")


def phase_kd_pipeline(torch, M, build_mod, dev) -> None:
    P = kd_pipeline_module()
    say(f"[kd pipeline] run('vgg11', {KD_STEPS}, policy={KD_POLICY!r}, "
        f"width=1.0): ANN ResNet-18 teacher, VGG-11 student, batch "
        f"{P.BATCH}, 32x32 images at noise 0.8, seed 0")
    rec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = P.run("vgg11", KD_STEPS, policy=KD_POLICY, width=1.0, device=dev,
                record=rec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build_mod.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    say(f"[kd pipeline] launches over the run: {launches}")
    for kernel in ("lif_update", "spike_matmul", "spike_matmul_dx",
                   "spike_matmul_dw", "w2ttfs_pool"):
        require(launches[kernel] > 0, f"kd pipeline: {kernel} never "
                                      f"launched")
    for stage, acc in res.items():
        require(math.isfinite(acc), f"kd pipeline: {stage} accuracy {acc}")
    say("[kd pipeline] stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rec["seconds"].items())
        + f"; the run {seconds:.3f} s; peak memory {peak / 2**30:.3f} GiB "
        f"({(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} "
        f"held before it)")
    import numpy as np

    for stage, ms in rec["step_ms"].items():
        p10, p50, p90 = np.percentile(ms, [10, 50, 90])
        say(f"[timing] kd pipeline {stage} step: median {p50:.3f} ms, p10 "
            f"{p10:.3f}, p90 {p90:.3f}, first {ms[0]:.3f} over {len(ms)} "
            f"steps")
    kd_first_step_gate(torch, M, build_mod, P, rec, dev)
    kd_head_gate(torch, P, rec, dev)
    build_mod.reset_launches()
    per_img = {pol: P.deployment_spikes("vgg11", pol, width=1.0, device=dev)
               for pol in ("fused_dense", "fused_packed")}
    launches = dict(build_mod.LAUNCHES)
    say(f"[kd pipeline] deployment artifact (fused + int8, 16 images): "
        f"total_spikes/img {per_img}; launches {launches}")
    require(per_img["fused_dense"] == per_img["fused_packed"],
            f"deployment spikes differ between formats: {per_img}")
    for kernel in ("lif_update", "fused_pe", "w2ttfs_pool", "pack_spikes",
                   "unpack_spikes"):
        require(launches[kernel] > 0, f"deployment: {kernel} never "
                                      f"launched")


# ----------------------------------------------------------------- phase 13
CONTRACT_KERNELS = ("lif_update", "fused_pe", "spike_matmul", "w2ttfs_pool",
                    "pack_spikes", "unpack_spikes", "qk_attention",
                    "fused_pe_gated", "spike_matmul_gated", "flash_attention")


def phase_contracts(torch, build_mod, dev) -> None:
    from repro_torch.analysis.contracts import device_check, verify_contracts

    t0 = time.perf_counter()
    report = verify_contracts()
    t1 = time.perf_counter()
    require(not report.findings, "contract sweep: "
            + "; ".join(str(f) for f in report.findings[:5]))
    require(report.coverage == report.registered,
            f"contract sweep: uncovered {sorted(report.uncovered)}")
    build_mod.reset_launches()
    n, bad = device_check(dev, report)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build_mod.LAUNCHES)
    say(f"[contracts] the sweep on the CPU: {len(report.coverage)}/"
        f"{len(report.registered)} (op, mode) pairs, {report.cells} cells "
        f"({report.abstract} on fake tensors, {report.concrete} on seeded "
        f"operands), {t1 - t0:.3f} s; {n} fused cells on {dev}: "
        f"{len(bad)} mismatches, {t2 - t1:.3f} s; launches {launches}")
    require(not bad, "contracts on the card: " + "; ".join(bad[:5]))
    for kernel in CONTRACT_KERNELS:
        require(launches[kernel] > 0, f"contracts: {kernel} never launched")


# ----------------------------------------------------------------- phase 14
DRYRUN_POLICIES = ("reference+grad", "fused_dense+grad")
DRYRUN_PEAK_BAND = 0.10   # predicted peak against max_memory_allocated


def storage_bytes(torch, *trees) -> int:
    """Bytes of the distinct storages under ``trees``."""
    from repro_torch.launch.hlo_analysis import tensors

    seen = {}
    for t in tensors(list(trees)):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def first_difference(a: list, b: list) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x["op"] != y["op"]:
            return f"entry {i}: {x['op']} != {y['op']}"
    return f"lengths {len(a)} != {len(b)}"


def dryrun_real_step(torch, build_mod, dev, cfg, hlo) -> dict:
    """One untimed ``make_train_step`` step of phase 11's cell on the card
    (NCCL, a world of one), recorded: the argument bytes on the card, the
    record, its analysis and memory fields, the step's own peak by the
    allocator and the launches."""
    from repro_torch.configs import build_model
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch import mesh as M
    from repro_torch.optim import constant_lr
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import tree_leaves

    model = build_model(cfg)
    made = M.init_distributed(dev)
    try:
        state = train_state_init(model.init(
            torch.Generator(device=dev).manual_seed(0), device=dev))
        ds = SyntheticTokenDataset(cfg.vocab_size, LM_TRAIN_SEQ + 1)
        batch = {"tokens": torch.from_numpy(ds.batch(0, LM_TRAIN_BATCH)).to(
            dev)}
        world = M.Mesh((1, 1), ("data", "model"), device=dev)
        step = make_train_step(model, schedule=constant_lr(3e-4),
                               weight_decay=0.1, clip_norm=1.0,
                               dp_group=world.get_group(("data",)))
        args = storage_bytes(torch, state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        build_mod.reset_launches()
        with hlo.OpRecorder((state, batch), donated=state) as rec:
            out = step(state, batch)
        torch.cuda.synchronize()
        launches = dict(build_mod.LAUNCHES)
        # the step's own peak, with the arguments it was called on
        peak = torch.cuda.max_memory_allocated() - base + args
        res = {"arguments": args, "record": rec.record,
               "analysis": hlo.analyze(rec.record),
               "memory": rec.memory_analysis(out), "peak": peak,
               "launches": launches, "loss": float(out[1]["loss"]),
               "leaves": len(tree_leaves(state.params))}
        del state, batch, out, step, rec
    finally:
        if made:
            M.shutdown_distributed()
    torch.cuda.empty_cache()
    return res


def phase_dryrun(torch, build_mod, dev, smi: str) -> None:
    """The dry runs held against the card (phase 14): phase 11's cell
    traced on fake CPU tensors (``launch.dryrun.run_cell`` at a (1, 1)
    mesh), then the same step run once on the card under the recorder."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, hlo_analysis as hlo, roofline
    from repro_torch.launch.mesh import Mesh

    t_phase = time.perf_counter()
    shape = ShapeSpec(f"driver_{LM_TRAIN_BATCH}x{LM_TRAIN_SEQ}", "train",
                      LM_TRAIN_SEQ + 1, LM_TRAIN_BATCH)
    outdir = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(outdir, ignore_errors=True)
    one = Mesh((1, 1), ("data", "model"), device="cpu")
    records = []
    for policy in DRYRUN_POLICIES:
        overrides = dict(SPIKING_QK, policy=policy)
        t0 = time.perf_counter()
        fake = dryrun.run_cell(LM_ARCH, shape, "single", outdir,
                               overrides=overrides, tag=policy.replace(
                                   "+", "_"), mesh=one)
        fake_s = time.perf_counter() - t0
        records.append(fake)
        fake_ops = dryrun.read_ops(
            outdir / f"{LM_ARCH}__{shape.name}__single__"
                     f"{policy.replace('+', '_')}.ops.gz")
        t0 = time.perf_counter()
        real = dryrun_real_step(torch, build_mod, dev,
                                get_config(LM_ARCH, **overrides), hlo)
        real_s = time.perf_counter() - t0
        want = lm_step_launches(build_mod, get_config(LM_ARCH).n_layers,
                                policy)
        require(real["launches"] == want,
                f"[dryrun] {policy}: the step launched {real['launches']} "
                f"!= {want}")
        fa, ra = fake["hlo"], real["analysis"]
        pred_args = fake["per_device_bytes"]["arguments"]
        pred_peak = fake["memory_analysis"]["peak_bytes"]
        ratio = pred_peak / real["peak"]
        n_coll = [sum(e["op"].startswith("c10d.") for e in r)
                  for r in (fake_ops, real["record"])]
        useful = fake["model_flops"] / fa["flops"]
        say(f"[dryrun] {policy} {smi}: fake trace {fake['trace_s']} s "
            f"({fake_s:.1f} s with the spec half), the card's step "
            f"{real_s:.1f} s (init, one untimed step, loss "
            f"{real['loss']!r}); ops {len(fake_ops)} / {len(real['record'])}"
            f" (fake / card), flops {fa['flops']!r} / {ra['flops']!r}, "
            f"bytes {fa['bytes']!r} / {ra['bytes']!r}, all-reduces "
            f"{n_coll[0]} / {n_coll[1]}; arguments {pred_args} predicted, "
            f"{real['arguments']} on the card; peak {pred_peak} predicted "
            f"(arguments {fake['memory_analysis']['argument_size_in_bytes']}"
            f" + temp {fake['memory_analysis']['temp_size_in_bytes']}), "
            f"{real['peak']} by max_memory_allocated (the step's own plus "
            f"its arguments): ratio {ratio:.4f}; the recorder on the card: "
            f"temp {real['memory']['temp_size_in_bytes']}; useful ratio "
            f"6 N D / traced flops {useful:.4f}; launches "
            f"{ {k: v for k, v in real['launches'].items() if v} }")
        # (a) the spec half's argument bytes are the card's
        require(pred_args == real["arguments"],
                f"[dryrun] {policy}: predicted arguments {pred_args} != "
                f"{real['arguments']} on the card")
        # (c) the recorded all-reduces: one a gradient leaf and the
        # metrics' one, in the fake trace and on the card alike
        n_leaves = real["leaves"]
        require(n_coll[0] == n_coll[1] == n_leaves + 1,
                f"[dryrun] {policy}: all-reduces {n_coll} (fake, card), "
                f"want {n_leaves} leaves + 1")
        if policy.startswith("reference"):
            # (b) the reference step's record on the card is the trace's
            require(len(fake_ops) == len(real["record"])
                    and [e["op"] for e in fake_ops]
                    == [e["op"] for e in real["record"]],
                    f"[dryrun] {policy}: op records differ: "
                    f"{first_difference(fake_ops, real['record'])}")
            require(fa["flops"] == ra["flops"] and fa["bytes"] == ra["bytes"],
                    f"[dryrun] {policy}: flops {fa['flops']} / {ra['flops']}"
                    f", bytes {fa['bytes']} / {ra['bytes']} (fake / card)")
            # (d) the predicted peak against the allocator's
            require(abs(ratio - 1.0) <= DRYRUN_PEAK_BAND,
                    f"[dryrun] {policy}: predicted peak {pred_peak} against "
                    f"{real['peak']} on the card: ratio {ratio:.4f}")
        del real, fake_ops
    t0 = time.perf_counter()
    cells = dryrun.spec_records(["single", "multi"])
    spec_s = time.perf_counter() - t0
    for c in cells:
        b = c["per_device_bytes"]
        say(f"[dryrun] spec {c['arch']} {c['shape']} {c['mesh']}: "
            f"{c['n_chips']} chips, per device {b['arguments'] / 1e9:.3f} GB"
            f" ({', '.join(f'{k} {v}' for k, v in b.items())}); "
            f"model flops {c['model_flops']:.4e}")
    say(f"[dryrun] the spec half of {len(cells)} registry cells in "
        f"{spec_s:.1f} s; the report, priced as one "
        f"{roofline.H100_SXM.name} (data sheet):")
    table = roofline.markdown(
        [roofline.analyze_cell(r) for r in records + cells])
    for line in table.splitlines():
        say(f"[dryrun] {line}")
    say(f"[dryrun] phase {time.perf_counter() - t_phase:.1f} s")


def kernels_namespace(torch):
    """The launchers, plain versions and helpers the phases call."""
    from repro_torch.core import events
    from repro_torch.kernels import _build
    import repro_torch.kernels.flash_attention as flash_attention
    import repro_torch.kernels.fused_pe as fused_pe
    import repro_torch.kernels.lif_update as lif_update
    import repro_torch.kernels.packed as packed
    import repro_torch.kernels.qk_attention as qk_attention
    import repro_torch.kernels.spike_matmul as spike_matmul
    import repro_torch.kernels.w2ttfs_pool as w2ttfs_pool
    from repro_torch.kernels import chain

    def launch_empty():
        _build.check(_build.library().repro_empty(
            torch.cuda.current_stream().cuda_stream), "repro_empty")

    return types.SimpleNamespace(
        launch_empty=launch_empty,
        fused_pe_cuda=fused_pe.fused_pe_cuda,
        fused_pe_block_ref=fused_pe.fused_pe_block_ref,
        RECHECK_BAND=fused_pe.RECHECK_BAND,
        fused_pe_operands=fused_pe.fused_pe_operands,
        fused_pe_tile_operands=fused_pe.fused_pe_tile_operands,
        float_tile_plan=fused_pe.float_tile_plan,
        FLOAT_TILE_RESIDENT=fused_pe.ops.FLOAT_TILE_RESIDENT,
        spike_matmul_tile_operands=spike_matmul.spike_matmul_tile_operands,
        tile_plan=spike_matmul.tile_plan,
        block_width=spike_matmul.block_width,
        spike_matmul_chain_ref=spike_matmul.spike_matmul_chain_ref,
        fma_chain=chain.fma_chain, chain_launchers=chain.chain_launchers,
        head_gate=fused_pe.head_gate,
        pack_words=events.pack_words,
        DECODE_ROWS=spike_matmul.DECODE_ROWS,
        spike_matmul_cuda=spike_matmul.spike_matmul_cuda,
        spike_matmul_block_ref=spike_matmul.spike_matmul_block_ref,
        spike_matmul_operands=spike_matmul.spike_matmul_operands,
        spike_matmul_gated_cuda=spike_matmul.spike_matmul_gated_cuda,
        spike_matmul_gated_block_ref=spike_matmul.spike_matmul_gated_block_ref,
        spike_matmul_dw_gated_cuda=spike_matmul.spike_matmul_dw_gated_cuda,
        spike_matmul_dw_gated_ref=spike_matmul.spike_matmul_dw_gated_ref,
        dw_gate=spike_matmul.dw_gate,
        compact_kmap=events.compact_kmap,
        spike_matmul_dx_cuda=spike_matmul.spike_matmul_dx_cuda,
        spike_matmul_dx_ref=spike_matmul.spike_matmul_dx_ref,
        spike_matmul_dw=spike_matmul.spike_matmul_dw,
        spike_matmul_dw_cuda=spike_matmul.spike_matmul_dw_cuda,
        spike_matmul_dw_ref=spike_matmul.spike_matmul_dw_ref,
        vld_map=spike_matmul.vld_map,
        dw_plan=spike_matmul.dw_plan,
        dx_plan=spike_matmul.dx_plan,
        spike_matmul_dw_split_ref=spike_matmul.spike_matmul_dw_split_ref,
        qk_attention_cuda=qk_attention.qk_attention_cuda,
        flash_attention_cuda=flash_attention.flash_attention_cuda,
        flash_pick_route=flash_attention.pick_route,
        flash_wgmma_instance=flash_attention.wgmma_instance,
        attention_ref=flash_attention.attention_ref,
        qk_attention_ref=qk_attention.qk_attention_ref,
        lif_update_cuda=lif_update.lif_update_cuda,
        lif_update_ref=lif_update.lif_update_ref,
        w2ttfs_pool_cuda=w2ttfs_pool.w2ttfs_pool_cuda,
        w2ttfs_pool_fc_ref=w2ttfs_pool.w2ttfs_pool_fc_ref,
        pack_spikes=packed.pack_spikes,
        pack_spikes_cuda=packed.pack_spikes_cuda,
        unpack_spikes_cuda=packed.unpack_spikes_cuda,
        pack_spikes_ref=packed.pack_spikes_ref,
        unpack_spikes_ref=packed.unpack_spikes_ref,
        unpack_words=events.unpack_words,
        popcount32=events.popcount32,
        PackedSpikes=events.PackedSpikes,
        check_packed_invariants=events.check_packed_invariants,
        block_count_map_2d=events.block_count_map_2d,
        gated_mask=spike_matmul.gated_mask)


def training_namespace():
    """The model, data, optimizer and trainer entry points the training
    phase drives."""
    from repro_torch.core.kd import KDConfig
    from repro_torch.data.synthetic import SyntheticImageDataset
    from repro_torch.models import ann_cnn, snn_cnn
    from repro_torch.ops import as_policy
    from repro_torch.ops import get_tuner
    from repro_torch.optim import cosine_lr, sgd_init
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves

    return types.SimpleNamespace(
        KDConfig=KDConfig, SyntheticImageDataset=SyntheticImageDataset,
        ann_cnn=ann_cnn, snn_cnn=snn_cnn, as_policy=as_policy,
        get_tuner=get_tuner,
        cosine_lr=cosine_lr, sgd_init=sgd_init, trainer=trainer,
        tree_leaves=tree_leaves)


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              f"(no {SRC / 'repro_torch'} here)", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run on "
              "the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import ops
    from repro_torch.kernels import _build
    from repro_torch.ops import fallback
    from repro_torch.models import snn_cnn

    K = kernels_namespace(torch)
    M = training_namespace()
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    marks = [t_start]

    def lap(tag: str) -> None:
        """Print a phase's own seconds beside the running total. No phase
        may leave a fused op demoted to its reference (the guard in
        ``ops.fallback`` would hide a kernel that failed to build or
        launch): the chaos phase resets the demotions it made."""
        require(fallback.demotions() == [],
                f"{tag}: fused ops demoted {fallback.demotions()}")
        now = time.perf_counter()
        say(f"[{tag}] done: {now - marks[-1]:.1f} s this phase "
            f"({now - t_start:.1f} s so far)")
        marks.append(now)

    smi = phase_setup(torch)
    phase_build(_build)
    lap("build")
    parity = phase_parity(torch, K, dev)
    say("[parity] all kernels agree with their plain versions")
    lap("parity")
    phase_constants(torch, K, dev)
    lap("constants")
    cfg, fused, images, paths = phase_end_to_end(torch, snn_cnn, _build, dev,
                                                 BATCH)
    for policy in ("fused_dense", "fused_packed"):
        paths[f"{policy} busy"] = paths[policy]
    phase_vgg(torch, snn_cnn, _build, dev, VGG_BATCH)
    lap("e2e")
    models, traces = phase_auto(torch, snn_cnn, _build, ops, dev, images,
                                paths)
    names = tuned_layer_names(cfg, snn_cnn)
    for label in ("auto busy", "auto_packed busy"):
        say(f"[plans] {label}: the card's plan of each layer per sparsity "
            f"bucket (kernels r/f, skip, block_n)")
        phase_plans(traces[label], names)
    lap("auto")
    train_paths = phase_training(torch, M, _build, dev, TRAIN_BATCH)
    auto_train = phase_auto_training(torch, M, _build, dev, TRAIN_BATCH,
                                     models["quiet"][0], names)
    lap("train")
    paths.update(phase_timesteps(torch, M, _build, dev, images, BATCH))
    paths[PACKED_DW_PATH] = phase_packed_dw(
        torch, K, _build, train_paths["fold", "fused_packed+grad"].captured)
    for tp in (train_paths["fold", "fused_dense+grad"],
               train_paths["fold", "fused_packed+grad"],
               train_paths["unfused", "fused_dense+grad"],
               *auto_train.values()):
        paths[tp.name] = (None, None, tp.launches[0], tp.captured)
    lap("T")
    paths["explicit skip"] = phase_explicit(
        torch, K, _build, ops, paths,
        auto_train["train fold fused_dense+grad quiet"].captured)
    for kernel in NO_GATED:
        ran = [p for p in GATED_PATHS[:-1] if paths[p][2][kernel] > 0]
        say(f"[auto] {kernel}: "
            + (f"launched by the tuner's plans on {ran}" if ran else
               "the card's cost model planned it on no auto path; "
               "launched with an explicit skip on the model's operands "
               f"({paths['explicit skip'][2][kernel]} launches)"))
    paths.update(phase_serve(torch, serve_namespace(), K, _build, dev))
    lap("serve")
    phase_chaos(torch, serve_namespace(), chaos_namespace(), _build, dev,
                smi)
    lap("chaos")
    paths.update(phase_softmax(torch, serve_namespace(), K, _build, dev,
                               parity))
    lap("softmax")
    # the LM training step holds two generations of parameters and AdamW
    # moments (48 GB): the earlier phases' captured launches wait in host
    # memory meanwhile
    parking = Parking(torch)
    held = torch.cuda.memory_allocated() / 2 ** 30
    parking.park([p[3] for p in paths.values()], "cpu")
    say(f"[lm train] the earlier phases' captured launches moved to host "
        f"memory: {held:.3f} GiB on the card before, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB after")
    lm_paths, lm_dense = phase_lm_train(torch, serve_namespace(),
                                        lm_train_namespace(), K, _build,
                                        dev, parking)
    paths.update(lm_paths)
    lap("lm train")
    # the other LM families at full width hold up to 42 GB of parameters
    # and their bf16 copies: they run while the launches wait there too
    paths.update(phase_families(torch, serve_namespace(), K, _build, dev))
    lap("families")
    phase_driver(torch, _build, dev, smi, lm_dense)
    lap("driver")
    phase_kd_pipeline(torch, M, _build, dev)
    lap("kd pipeline")
    phase_contracts(torch, _build, dev)
    lap("contracts")
    phase_dryrun(torch, _build, dev, smi)
    lap("dryrun")
    parking.park([p[3] for p in paths.values()], "cuda")
    rows = phase_timing(torch, K, snn_cnn, models, images, paths, parity,
                        ITERS, ops.get_tuner())
    time_training(torch, M, train_paths, TRAIN_BATCH, TRAIN_ITERS)
    time_training(torch, M, {("fold quiet", p.policy): p
                             for p in auto_train.values()},
                  TRAIN_BATCH, TRAIN_ITERS, profile=False)
    lap("timing")
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
