#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`moco_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases; any failure ends the run with a nonzero exit and no result line:

1.  build   compile moco_tpu_torch/csrc/*.cu with nvcc for sm_90a
            (channel_stats, blur, fused_conv, fused_conv_dw, conv3x3_dw,
            conv3x3_fwd, matmul_fwd, matmul_dw);
2.  kernels each CUDA kernel against its plain PyTorch version on the card,
            at the shapes the ResNet-50 batch-256 step gives it, with its
            time, its bound, the plain version's time and one PyTorch
            library call's time as a yardstick (for the fused BN->ReLU->conv
            kernels: the product alone, on an already-normalized operand);
            the BN reduction pair at all 12 ResNet-50 BN shapes and the
            blur at the step's [256, 224, 224, 3], each run twice with the
            same bits, timed as eager calls and as a CUDA graph of the same
            calls (device time), inputs rotated past L2;
3.  slice   a few steps of the `imagenet-moco-v2` preset (ResNet-50, 224 px,
            bf16, K=65536, MLP head, T=0.2) at batch 256 on synthetic data
            through `moco_tpu_torch.train`, fed by `epoch_loader` (4 staging
            workers, depth 2; its first two batches held bit for bit against
            `get_batch` and a plain copy), with the kernels' launch counts
            (the blur's on its R = 11 route), then one profiled steady step
            (the BN pair and the blur: one launch per call; device busy and
            idle against the step's wall time);
3b. fused   the same with `fused_bn_conv=True` (the blocks' interior
            bn->relu->conv passes through the fused kernels);
4.  imagefolder  the same unfused step from a generated JPEG tree (576
            images, 8 classes, ImageNet-like sizes in both orientations)
            through `ImageFolder` at stage size 512 and the Prefetcher, its
            first two batches (rot-staged samples among them) held bit for
            bit against a plain copy; run twice, with `h2d_trim` off and on;
            imgs/s, peak memory, staging and decode time, credit stalls;
5.  check   a small f32 ResNet and one BatchNorm on the card against the
            same on the CPU (where every wrapper takes its plain version);
5b.         the same small ResNet with `fused_bn_conv=True`;
5c. phase5  checkpoints and evals at ResNet-50's full width: 2 pretrain
            steps with a checkpoint (the BN pair and the blur launching),
            a save and a resume into a fresh state held bit for bit (every
            tensor, both generators, the queue pointer, the step), one more
            step of each under deterministic cuDNN (loss, logits and
            enqueued keys equal); the query encoder exported to .npz and
            loaded by the surgery for resnet50; `encode_dataset` of a
            4096-image bank and 1024 queries (f32 eval forward, no port
            kernel launched) and the kNN with the bank streamed in 1024-row
            chunks, held against the CPU (the features of 32 images within
            FEATURE_ATOL; predictions equal except at ties, counted); the
            linear probe (1000 classes) for an epoch, a probe checkpoint,
            a resumed second epoch, `--evaluate` of each, `sanity_check`;
            the timings beside the card's name and power limit;
6.  phase6  the data-parallel step and the prestage: `train.train` in a
            one-rank NCCL group (a FileStore rendezvous), 3 steps of
            phase 3's configuration unfused and fused, each held bit for
            bit (losses, logits, enqueued keys, whole state) against the
            same run with no group under deterministic cuDNN, every kernel
            launched and the NCCL calls a step counted, the gradient
            all-reduce timed, imgs/s with and without the group; the TF32
            flags turned on before the first run and checked off after it
            (the package's precision policy); run just after phase 3b, on
            its data. Then, inside phase 4, its JPEG tree decoded once into
            a prestage (`data/service/prestage.py`), a batch of it held
            byte for byte against the PIL decode, and phase 4's steps from
            it through the driver's `input_prestage` branch: imgs/s, the
            first-batch stall, bytes per image and on disk.
7.  phase7  the gradient-sync modes and ZeRO-1, right after phase 6 in a
            new one-rank NCCL group: `train.train` for 3 steps of phase 3's
            configuration under deterministic cuDNN with grad_sync fused,
            bucketed (4 MB buckets reduced from the backward's hooks),
            quantized int8 and bf16, demo (topk 0.01) at cadence 1 and 2,
            and fused with zero_sharding; each run's imgs/s, peak memory,
            NCCL calls a step, exposed reduce time (CUDA events), analytic
            and carried bytes, accumulator bytes and largest entry;
            bucketed and zero_sharding held bit for bit against fused,
            the quantized runs' mean + error against their input, DeMo's
            k nonzeros a leaf on sync steps and zeros on off-steps, every
            kernel's launches; then `ShardedAdamW` and `ShardedLARS` over
            the group against the plain optimizers on ResNet-50's
            parameters (`check_sharded_optimizers`). Under `torchrun --nproc-per-node <cards>
            chip_smoke.py --phase7` the script builds the kernels and runs
            phase 7 alone, one process per card, and prints its results as
            one JSON line.
8.  phase8  the MoCo-v3 path, right after phase 7 on its data: (a)
            `imagenet-moco-v3-vits` (ViT-S/16, 224 px, bf16, the 4096 ->
            256 heads, AdamW, the momentum ramp, the asymmetric view pair)
            at batch 512 through `train.train`, 4 steps and one profiled
            (imgs/s, peak memory, busy/wall, the attention core's share, the
            blur's 2 launches a step; remat off), and the port's AdamW step
            over its parameters timed against `torch.optim.AdamW(fused=True)`;
            (b) `imagenet-moco-v3-r50` (LARS, T=1, crop-min 0.2) at batch
            256, 3 steps, with the BN pair's 212 + 106 and the blur's 2
            launches a step. In every v3 run the blur's launches of the first
            step (view 1 after normalize, view 2 on the [0, 1] image before
            solarize) are kept with their inputs and held against the f32
            plain version on those inputs, within one bf16 ulp; (c) the v3
            view pair from the same draws on the card (the blur kernel) and
            the CPU, with a wrong blur (the taps of the next sample) as the
            control the tolerance must catch, then a ViT-S step at batch 16
            in f32 on both from the same views and weights (loss, keys,
            gradient norms); (d) (a)'s backbone exported in the timm
            dialect, reloaded by `load_for_inference("vit_small")` bit for
            bit, and 4 `imagenet-lincls-v3` probe steps on it; (e) ViT-S at
            batch 128, 3 steps, in a one-rank NCCL group and with none, bit
            for bit. `python3 chip_smoke.py --phase8` runs phase 8 alone;
            under `torchrun --nproc-per-node <cards> chip_smoke.py --phase8`
            it runs (a) over every card at 1024 a card, remat on.
9.  phase9  the run telemetry and learning health, right after phase 8 on
            its data, under deterministic cuDNN: (a) phase 3's configuration
            for 10 steps (12 batches an epoch) with `telemetry_dir`,
            `trace_mode="full"`, `telemetry_stride`, `health_stride` and
            `telemetry_flush_steps` all 2, with telemetry alone (health off,
            spans at `steps`), and twice with both off (in the order off,
            on, telemetry alone, off), metrics on the host at step 1 only:
            losses, logits, enqueued keys and the whole state equal bit for
            bit, the kernels' launches equal; its `events.jsonl` holds one
            run_start naming the card and its datasheet peak, step records
            1-10 with device_s on the even steps, MFU in (0, 1) on every
            step, a finite health block on the odd ones, one
            run_end whose hbm_peak_bytes is within 1% of
            `max_memory_allocated`; the heartbeat parses, the spans hold
            stage_batch, decode_slice and h2d_shard; imgs/s with and without
            telemetry (steps 2-9 on a synchronized clock), MFU and the phase
            split beside the card's name and power limit; (b) a 4-step run
            whose `trace.trigger` arms a 2-step capture window with
            `trace_device_profile`: a trace_capture start and end, and one
            torch.profiler trace under traces/ naming channel_sums_rows and
            blur_rows; (d) (a)'s telemetry run in a one-rank NCCL group:
            comm_s (CUDA events around the gradient sync) and a pod record
            on the even steps, the state equal to (a)'s bit for bit; (c)
            `imagenet-moco-v3-vits` at batch 128 (cut for time) with health
            every 2 steps, 4 steps: MFU on every step, health blocks with
            the drift and no queue keys, the blur held on the run's own
            inputs. `python3 chip_smoke.py --phase9` runs phase 9 alone.
10. phase10 the resilience of the driver, right after phase 9 on its data,
            under deterministic cuDNN, at phase 3's configuration: (a) 10 steps
            with `loss_sentinel` off, on, on, off: imgs/s over steps 2-9 on a
            synchronized clock, how many of the sentinel's checks waited for
            their copy, losses, logits, enqueued keys and state equal bit for
            bit; (d) on (a)'s state, a synchronous save against two
            `wait=False` saves (the first with cold pinned memory), each
            followed at once by a step that updates the state in place: the
            call's hold, save plus step against a step alone, the manifest
            absent until `finalize_checkpoints`, the async-saved step
            restored equal to the synchronous one; (b) 2 steps an epoch, a
            checkpoint each, `nan_at_step=3`: the sentinel's and the rollback's
            events (in `events.jsonl` too), final step 5 after 7 executed
            steps, the time from detection to the restored state, steps 3-5
            equal to a pass resumed by hand from step 2 with the same skip;
            (c) a real SIGTERM after step 3 of 5: the emergency checkpoint
            at (0, 3) with its manifest, the heartbeat's `preempt_exit`, the
            resumed run's losses, logits, enqueued keys and state equal to
            the uninterrupted run's; (e) `watchdog_secs` 2 and a 3.3 s slow
            step: one flag naming step 2, none in two kNN monitor runs held
            3 s longer; (f) `python -m moco_tpu_torch.train --chaos
            sigterm_at_step=2` (96 px, batch 64) exits 43. Every run's
            kernels launch their counts a step executed. `python3
            chip_smoke.py --phase10` runs phase 10 alone.
11. phase11 the run supervisor, right after phase 10: `python -m
            moco_tpu_torch.train --preset imagenet-moco-v2 --dataset
            synthetic` (phase 3's configuration on the CLI's own 2048
            images, 2 steps an epoch and a checkpoint each, 6 steps,
            `--deterministic true`) under `resilience.supervisor.Supervisor`,
            against the same configuration run uninterrupted in this process
            through the phase's counters (the BN pair's and the blur's
            launches a step; their first calls held against the plain
            versions on the path's own inputs). (a) `kill_at_step=3`:
            `[killed, clean]`; (b) `freeze_at_step=3` under a 5 s staleness
            window: `[hang, clean]`, detected within twice the window; (c) a
            SIGTERM to the child once step 3 has run: `[preempted, clean]`.
            Each drill's per-step losses equal the uninterrupted run's bit for
            bit, no process of the run is left, and the phase prints the time
            from the death to the relaunched child's first step, the hang's
            detection against its window, and the emergency checkpoint's
            time. (d), with four cards: `--num-devices 4`, a chaos request
            for 2 cards after step 4, the operator's `resize.request` for 4
            once step 9 has run, then a SIGTERM to one of the four NCCL ranks
            once step 16 has run: `[resize, resize, preempted, clean]`,
            imgs/s at 4 and 2 cards, each hop's elastic checkpoint; with fewer
            cards it prints why it is skipped. `python3 chip_smoke.py
            --phase11` runs phase 11 alone, `--phase11d` its (d) alone.
12. phase12 cross-process BatchNorm and the input service, right after
            phase 11: (a) phase 3's configuration for 3 steps in a one-rank
            NCCL group under deterministic cuDNN with `sync_bn` off and on:
            losses, logits, enqueued keys and state equal bit for bit, the
            BN pair's and the blur's launches phase 3's a step, the
            all-reduces a step (3, and 3 + 159 with `sync_bn`: one a BN
            forward and backward), imgs/s, and (e) each run's first BN pair
            calls and first step's blurs held against their plain versions
            on the path's own inputs; (b) `fused_bn_conv` with `sync_bn`:
            no launch of kernels 4-8 in 2 steps; (c) phase 4's 576-JPEG tree
            served by 1, 2 and 4 staging servers (`LocalServerPool`, each a
            stdlib supervisor and a decode-worker process): the first
            epoch's batches on the card equal the in-process loader's bit
            for bit, and imgs/s of the driver fed by each (4 steps, batch
            256, `input_service`) against the in-process PIL decode and the
            in-process prestage, beside `os.cpu_count()`; (d)
            `kill_at_shard=2` on one of two servers: the epoch bit for bit,
            the seconds from the worker's death to its relaunch's first
            healthy probe. `python3 chip_smoke.py --phase12` runs phase 12
            alone; `--phase12d`, on a host with four cards,
            runs the CLI at `--num-devices 4 --sync-bn true` (64 a card)
            against one card at 256 without it (the first three losses
            within `PHASE12_D_RTOL`) and four cards without it, imgs/s of
            each; with fewer cards it prints why it is skipped.
13. phase13 the embedding service (`moco_tpu_torch/serve/`) on one card,
            after phase 5: (a) a ResNet-50 export (224 px) of a fresh
            imagenet-moco-v2 state, the engine over buckets 1/8/32/128 with
            one CUDA graph each (capture seconds; each graph bit for bit
            against the eager forward of the same batch and with other
            neighbours in the bucket; the largest difference of an image
            across buckets; rows against the CPU f32 forward); (b) the HTTP
            front end under 32 closed-loop clients: requests/s, latency
            p50/p99, batch occupancy, no error, still four graphs; (c) a hot
            reload to a second export under that load: no request dropped,
            each client's answers from the old engine, then the new; (d) a
            versioned bank built through the engine in 4 shards, its ANN
            index, and /v1/knn against the exact and the ANN service; (e)
            `ShardedAdamW` and `ShardedLARS` in a one-rank NCCL group
            against the plain optimizers. No kernel of the eight launches
            on this path. `python3 chip_smoke.py --phase13` runs it alone.
14. phase14 the replicated fleet (`python -m moco_tpu_torch.serve_fleet`)
            of two `python -m moco_tpu_torch.serve` replicas of phase 13's
            ResNet-50 export on the one card, obsd (`python -m
            moco_tpu_torch.obsd`) tailing its telemetry, and 32 closed-loop
            clients in a process of their own: (b) a chaos
            `kill_at_request` on replica 0 under 1024 requests, nothing
            lost, the death's class, death-to-healthy seconds, the router's
            retries; (a) requests/s, p50/p99 and 0 errors through the
            router, each answer against one replica's row, launch-to-healthy
            seconds and device memory; (c) a manifested second export and a
            truncated third step in the watch directory under load: the
            third quarantined, the roll's seconds, capacity never below
            N-1, nothing dropped, old rows then new ones; (e) obsd's
            /metrics, /runs and /slo, the fleet's and obsd's drains, obsd's
            only writes its slo lines; (d) phase 13's bank and index behind
            `--ann-shards 2`: /v1/knn equal to a full-index replica, then
            `partial: true` with one shard killed. No kernel of the eight
            launches. `python3 chip_smoke.py --phase14` runs it alone (with
            its own exports and bank).

15. phase15 FSDP for the v3 pretrain (`parallel/fsdp.py`):
            `imagenet-moco-v3-vitb` (ViT-B/16, 224 px, bf16, remat, AdamW) at
            batch 128 in a one-rank NCCL group under deterministic cuDNN,
            3 steps with `sharding="dp"` and 3 with "fsdp" (every parameter
            split over the one-rank fsdp group: shard, gather on use,
            release), losses, both encoders and AdamW's state equal bit for
            bit; the blur's 2 launches a step held against its plain
            version; the state's bytes a card, the memory allocated between
            steps and at the peak, the gather's CUDA-event time a step.
            `python3 chip_smoke.py --phase15` runs it alone; under
            `torchrun --nproc-per-node 4 chip_smoke.py --phase15`, at 256 a
            card: (a) fsdp (1 x 4) against dp bit for bit, a card's state
            bytes at most 0.27 of dp's; (b) fsdp_tp (2 x 2) bit for bit;
            (c) fsdp_tp with quantized int8, the two-hop reduce, losses
            within 5% of dp's, each hop's bytes; (d) a 4-rank fsdp
            checkpoint restored by a 2-rank fsdp run (`--phase15d DIR`
            under a two-process torchrun on cards 0 and 1): both encoders
            bit for bit, the accumulators zero.

16. phase16 config 1 (`cifar10-moco-v1`: ResNet-18 with the CIFAR stem,
            32 px, f32, K=4096, B=256) from a `cifar-10-batches-py` tree
            written from a seed (5 x 512 train, 512 test images): (a) the
            tree; (b) `python -m moco_tpu_torch.train --preset
            cifar10-moco-v1 --data-dir <tree>` for 3 epochs with its kNN
            monitor (the untrained row first, finite losses, the queue
            pointer 256 ahead a step, imgs/s), then 4 steps of it in this
            process with the BN pair's launches counted (2 and 1 a BN a
            step, 20 BNs) and the peak memory; (c) the BN pair at the four
            ResNet-18@32 shapes [262144, 64], [65536, 128], [16384, 256],
            [4096, 512] in f32 and bf16, as in phase 2, and one profiled
            step's launches and device records against the count worked out
            from the encoder's BNs; (d) on (b)'s export, the probe for an
            epoch with a checkpoint, `--evaluate` after a resume
            (`sanity_check` against the file) and kNN, each CLI exiting 0.
            `python3 chip_smoke.py --phase16` runs it alone.

The last three lines of standard output are the card's name and power
limit, one JSON object describing the kernels, and the result object.
Exits 2 without a CUDA device or without the `moco_tpu_torch` package next
to this script.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 dense tensor cores
STEPS = 6
FUSED_STEPS = 4             # the fused run: one warm-up step and three more
IMAGEFOLDER_STEPS = 5       # phase 4, each of its two runs (2 batches an epoch)
IMAGEFOLDER_IMAGES = 2 * 256 + 64
# (h, w) of the generated JPEGs: ImageNet-like sizes, landscape and portrait;
# 683x1024 is fit-downscaled into the 512x1024 canvas
IMAGEFOLDER_SIZES = ((375, 500), (500, 375), (480, 640), (500, 333), (683, 1024))
# The card's machine has PIL but no libjpeg headers (jpeglib.h), so the
# native stager cannot be built there: phase 4 decodes with PIL. The stager
# is held against the JAX package's build on the CPU (tests/test_torch_data.py).
IMAGEFOLDER_BACKEND = "pil"
BATCH = 256
# [N*H*W, C] of every R50 BN at batch 256, 224 px, and how many BNs of that
# shape one encoder has (53 in all); channel_sums runs twice a BN a step (q
# and k forwards), channel_grad_sums once (q backward)
R50_BN_SHAPES = {
    "stem": ((BATCH * 112 * 112, 64), 1), "l1_64": ((BATCH * 56 * 56, 64), 6),
    "l1_128": ((BATCH * 56 * 56, 128), 1), "l1_256": ((BATCH * 56 * 56, 256), 4),
    "l2_128": ((BATCH * 28 * 28, 128), 7), "l2_256": ((BATCH * 28 * 28, 256), 1),
    "l2_512": ((BATCH * 28 * 28, 512), 5), "l3_256": ((BATCH * 14 * 14, 256), 11),
    "l3_512": ((BATCH * 14 * 14, 512), 1), "l3_1024": ((BATCH * 14 * 14, 1024), 7),
    "l4_512": ((BATCH * 7 * 7, 512), 5), "l4_2048": ((BATCH * 7 * 7, 2048), 4),
}
BN_LAUNCHES = {"channel_sums": 2, "channel_grad_sums": 1}  # per BN per step
ROTATE_BYTES = 100e6        # inputs up to this size rotate through copies, so
                            # that a timed loop reads twice the 50 MB L2
SUM_RTOL = 1e-4             # |kernel - plain| <= 1e-4 * sum |term|, per channel
# The fused kernels at the R50 batch-256 shapes: 1x1 [M, K, N] (conv3, and
# its dW), stride-1 3x3 [B, H, W, K] with N = K (conv2 mids, and their dW),
# stride-2 3x3 inputs [B, H, W, K] with N = K (the stage-first conv2s).
FUSED_1X1_SHAPES = {"layer1": (BATCH * 56 * 56, 64, 256), "layer2": (BATCH * 28 * 28, 128, 512),
                    "layer3": (BATCH * 14 * 14, 256, 1024), "layer4": (BATCH * 7 * 7, 512, 2048)}
FUSED_3X3_SHAPES = {"layer1": (BATCH, 56, 56, 64), "layer2": (BATCH, 28, 28, 128),
                    "layer3": (BATCH, 14, 14, 256), "layer4": (BATCH, 7, 7, 512)}
FUSED_S2_SHAPES = {"layer2": (BATCH, 56, 56, 128), "layer3": (BATCH, 28, 28, 256),
                   "layer4": (BATCH, 14, 14, 512)}
FUSED_RTOL = 1e-5           # f32 reassociation, relative to sum |z||w| per output
# launches per imagenet-moco-v2 step: the BN pair and the blur, and the fused family
# with fused_bn_conv=True (16 Bottlenecks, 3 stride-2; q and k forwards, q
# backward)
PER_STEP = {"channel_sums": 106, "channel_grad_sums": 53, "gaussian_blur_batch": 2}
FUSED_PER_STEP = {"bn_relu_matmul": 32, "bn_relu_matmul_dw": 16, "bn_relu_conv3x3": 26,
                  "bn_relu_conv3x3_s2": 6, "conv3x3_dw": 13}
# the device records of the kernels the profile holds against the wrappers'
# launch counts ("channel_sums_rows" is not part of "channel_grad_sums_rows")
PORT_RECORDS = {"channel_sums": "channel_sums_rows",
                "channel_grad_sums": "channel_grad_sums_rows",
                "gaussian_blur_batch": "blur_rows"}
PROFILE_TRIES = 3
# phase 5: the kNN bank and queries (224 px), the streamed bank's chunk, the
# bank images whose features the CPU computes too, their tolerance (unit
# vectors from f32 forwards on both sides, TF32 off), and the probe's steps
# an epoch
PHASE5_BANK = 4096
PHASE5_QUERIES = 1024
PHASE5_CHUNK = 1024
PHASE5_CPU_FEATURES = 32
FEATURE_ATOL = 1e-4
PHASE5_PROBE_STEPS = 4
DIST_STEPS = 3              # phase 6: steps of each run, with and without the group


def fail(msg: str, code: int = 2) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time in ms for the bytes at the HBM rate and the operations at
    `ops_per_s` (f32 outside the tensor cores unless given), and which of
    the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device time of `fn` over `iters` calls captured in one CUDA
    graph and replayed (CUDA events around the replays): the kernels' time
    with no host in between."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up on the capture stream
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def _copies(tensors: tuple, nbytes: float) -> list:
    """The inputs of one call (`nbytes` in all) and enough copies of them
    that a loop over the copies reads more than ROTATE_BYTES; inputs larger
    than that alone."""
    n = math.ceil(ROTATE_BYTES / nbytes) if nbytes <= ROTATE_BYTES else 1
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def _sums_close(kname: str, shape_name: str, got, ref, scale) -> float:
    err = 0.0
    for g, r, s in zip(got, ref, scale):
        diff = (g - r).abs()
        if not bool((diff <= SUM_RTOL * s).all()):
            fail(f"{kname}[{shape_name}] disagrees: max rel {float((diff / s).max()):.3e}", 1)
        err = max(err, float(diff.max()))
    return err


def check_stats_kernels(stats, shapes: dict = R50_BN_SHAPES, dtype: str = "bfloat16",
                        label: str = "kernel") -> dict:
    """channel_sums / channel_grad_sums at every BN shape of `shapes` (all
    12 R50 BN shapes by default) in `dtype`: each against its plain
    version, twice with the same bits; its time in eager back-to-back calls
    ("call ms") and in a CUDA graph of the same calls ("device ms"), with
    inputs of 100 MB or less rotated through copies; the library call's the
    same two ways; and the sums over one step's launches."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    short = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    report = {"channel_sums": {}, "channel_grad_sums": {}}
    for name, ((m, c), n_bn) in shapes.items():
        x = (torch.randn((m, c), generator=gen, device="cuda") * 2 + 0.5).to(dt)
        dy = torch.randn((m, c), generator=gen, device="cuda").to(dt)
        xf = x.float()
        mean = xf.mean(0)
        rstd = torch.rsqrt(xf.var(0, correction=0) + 1e-5)
        dyf = dy.float()
        cases = {
            "channel_sums": dict(
                run=lambda a: stats.channel_sums(a[0]),
                plain=lambda a: stats.channel_sums_plain(a[0]),
                library=lambda a: torch.var_mean(a[0], dim=0, correction=0),
                inputs=_copies((x,), m * c * x.element_size()),
                scale=(xf.abs().sum(0), (xf * xf).sum(0)),
                bound=bound(m * c * x.element_size() + 2 * c * 4, 3 * m * c)),
            "channel_grad_sums": dict(
                run=lambda a: stats.channel_grad_sums(a[0], a[1], mean, rstd),
                plain=lambda a: stats.channel_grad_sums_plain(a[0], a[1], mean, rstd),
                library=lambda a: torch.batch_norm_backward_reduce(
                    a[0], a[1], mean, rstd, None, True, False, False),
                inputs=_copies((dy, x), 2 * m * c * x.element_size()),
                scale=(dyf.abs().sum(0), (dyf * (xf - mean) * rstd).abs().sum(0)),
                bound=bound(2 * m * c * x.element_size() + 4 * c * 4, 6 * m * c)),
        }
        del xf, dyf
        for kname, k in cases.items():
            inputs = k["inputs"]
            got = k["run"](inputs[0])
            again = k["run"](inputs[0])
            err = _sums_close(kname, name, got, k["plain"](inputs[0]), k["scale"])
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                fail(f"{kname}[{name}] gave other bits on a second run", 1)
            n = len(inputs)
            iters = n * math.ceil(20 / n)
            cycle = itertools.cycle(inputs)

            def each(fn):  # each call on the next copy
                return lambda: fn(next(cycle))

            r = dict(shape=[m, c], bns=n_bn, copies=n, max_abs_err=err,
                     ms=time_ms(each(k["run"]), iters),
                     device_ms=graph_ms(each(k["run"]), iters),
                     plain_ms=time_ms(each(k["plain"]), 3),
                     library_ms=time_ms(each(k["library"]), iters),
                     library_device_ms=graph_ms(each(k["library"]), iters),
                     bound_ms=k["bound"][0], bound_by=k["bound"][1])
            report[kname][name] = r
            print(f"{label} {kname} {name} [{m}, {c}] {short} x{n_bn}: call {r['ms']:.4f} ms, "
                  f"device {r['device_ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']}, {100 * r['bound_ms'] / r['device_ms']:.0f}% of it; plain "
                  f"{r['plain_ms']:.4f} ms; library call {r['library_ms']:.4f} ms, device "
                  f"{r['library_device_ms']:.4f} ms; {n} input copies; max abs err "
                  f"{err:.3e})", flush=True)
        del x, dy, cases
        torch.cuda.empty_cache()
    for kname, rows in report.items():
        per = BN_LAUNCHES[kname]
        launches = sum(per * r["bns"] for r in rows.values())
        total = {key: sum(per * r["bns"] * r[key] for r in rows.values())
                 for key in ("device_ms", "ms", "bound_ms", "library_device_ms")}
        print(f"{label} {kname} {short} per step: {launches} launches, device "
              f"{total['device_ms']:.4f} ms "
              f"(call {total['ms']:.4f} ms), bound {total['bound_ms']:.4f} ms "
              f"({total['device_ms'] / total['bound_ms']:.2f}x), library device "
              f"{total['library_device_ms']:.4f} ms", flush=True)
    return report


def blur_library(images, taps, radius: int):
    """Yardstick: edge pad + a pair of grouped F.conv2d (one group per
    sample and channel). The port never calls this."""
    import torch.nn.functional as F

    b, h, w, _ = images.shape
    x = images.permute(0, 3, 1, 2).reshape(1, b * 3, h, w)
    x = F.pad(x, (radius, radius, radius, radius), mode="replicate")
    k = taps.repeat_interleave(3, dim=0).to(images.dtype)
    y = F.conv2d(x, k.view(b * 3, 1, -1, 1), groups=b * 3)
    return F.conv2d(y, k.view(b * 3, 1, 1, -1), groups=b * 3)


def identity_rows(taps, radius: int):
    """The samples whose taps are exactly the one-hot identity. A small
    sigma also rounds its centre tap to 1.0, but its outer taps stay about
    1e-22 and move a zero pixel off zero."""
    return (taps[:, radius] == 1.0) & (taps.count_nonzero(dim=1) == 1)


def bf16_ulp(ref):
    """One bf16 ulp of an f32 reference, floored at that of 2^-8: f32
    reassociation over 23 taps of |x| <= 5 stays below 1e-5."""
    import torch

    return torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0**-8))) - 7)


def check_blur_kernel(blur) -> dict:
    """gaussian_blur_batch at the step's shape ([256, 224, 224, 3] bf16,
    R = 11, on the R = 11 instantiation): within one bf16 ulp of the f32
    plain version, identity samples unchanged, the same bits twice; its
    time in eager calls ("call ms") and in a CUDA graph of the same calls
    ("device ms"), inputs rotated past L2; the library yardstick the same
    two ways; the share of the bound reached and the sum over one step's
    launches."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    radius = blur.blur_radius(224)
    images = torch.randn((BATCH, 224, 224, 3), generator=gen, device="cuda").bfloat16()
    taps = blur.blur_weights(BATCH, radius, (0.1, 2.0), 0.5, gen, "cuda")
    fixed = blur.gaussian_blur_batch.routes["fixed"]
    got = blur.gaussian_blur_batch(images, taps, radius)
    again = blur.gaussian_blur_batch(images, taps, radius)
    if blur.gaussian_blur_batch.routes["fixed"] != fixed + 2:
        fail("gaussian_blur_batch at R = 11 did not take the R = 11 instantiation", 1)
    if not torch.equal(got, again):
        fail("gaussian_blur_batch gave other bits on a second run", 1)
    got = got.float()
    ref = blur.gaussian_blur_batch_plain(images.float(), taps, radius)  # f32, unrounded
    ulp = bf16_ulp(ref)
    diff = (got - ref).abs()
    if not bool((diff <= ulp).all()):
        fail(f"gaussian_blur_batch disagrees: {int((diff > ulp).sum())} values beyond "
             f"one bf16 ulp (max abs {float(diff.max()):.3e})", 1)
    ident = identity_rows(taps, radius)
    if not torch.equal(got[ident], images[ident].float()):
        fail("gaussian_blur_batch changed a sample whose taps are the identity", 1)
    err = float(diff.max())
    del got, again, ref, ulp, diff
    n = images.numel()
    inputs = _copies((images,), n * images.element_size())
    iters = len(inputs) * math.ceil(20 / len(inputs))
    cycle = itertools.cycle(inputs)

    def each(fn):  # each call on the next copy
        return lambda: fn(next(cycle)[0])

    def kernel(x):
        return blur.gaussian_blur_batch(x, taps, radius)

    def library(x):
        return blur_library(x, taps, radius)

    b_ms, b_by = bound(2 * n * images.element_size() + taps.numel() * 4, 4 * (2 * radius + 1) * n)
    r = dict(shape=list(images.shape), copies=len(inputs), max_abs_err=err,
             ms=time_ms(each(kernel), iters), device_ms=graph_ms(each(kernel), iters),
             plain_ms=time_ms(lambda: blur.gaussian_blur_batch_plain(images, taps, radius), 3),
             library_ms=time_ms(each(library), 6), library_device_ms=graph_ms(each(library), 6),
             bound_ms=b_ms, bound_by=b_by)
    per = PER_STEP["gaussian_blur_batch"]
    print(f"kernel gaussian_blur_batch [{BATCH}, 224, 224, 3] bf16 R={radius}: call "
          f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
          f"{100 * b_ms / r['device_ms']:.0f}% of it; plain {r['plain_ms']:.4f} ms; library "
          f"call {r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f} ms; "
          f"{len(inputs)} input copies; max abs err {err:.3e})", flush=True)
    print(f"kernel gaussian_blur_batch per step: {per} launches, device "
          f"{per * r['device_ms']:.4f} ms (call {per * r['ms']:.4f} ms), bound "
          f"{per * b_ms:.4f} ms, library device {per * r['library_device_ms']:.4f} ms",
          flush=True)
    del inputs, cycle
    torch.cuda.empty_cache()
    return r


def _check_fused(name: str, shape_name: str, got, ref, scale, bf16_out: bool) -> float:
    """|kernel - plain| <= 1e-5 * sum |z||w| per output (f32 reassociation),
    plus one bf16 ulp of the f32 reference where the kernel rounds its
    output to bf16; returns the largest absolute difference."""
    import torch

    tol = FUSED_RTOL * scale
    if bf16_out:
        tol = tol + torch.exp2(torch.floor(torch.log2(ref.abs())) - 7)
    diff = (got.float() - ref).abs()
    bad = diff > tol
    if bool(bad.any()):
        fail(f"{name}[{shape_name}] disagrees: {int(bad.sum())} values beyond the tolerance "
             f"(max abs {float(diff.max()):.3e})", 1)
    return float(diff.max())


def check_fused_kernels(fc, fc3) -> dict:
    """The five fused BN->ReLU->conv kernels at the R50 shapes (bf16), each
    against its plain version computed in f32 from the same bf16 z. The
    bound counts each input read once and each output written once against
    the bf16 tensor-core peak; the library call is the product alone, on an
    already-normalized z ("product only": it leaves out the normalize the
    kernel fuses)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    report = {k: {} for k in FUSED_PER_STEP}

    def record(name, shape_name, shape, err, ms, plain_ms, lib_ms, nbytes, ops):
        b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
        tflops = ops / ms / 1e9  # the useful operations, over the kernel's time
        r = dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, tflops=tflops)
        report[name][shape_name] = r
        print(f"kernel {name} {shape_name} {list(shape)} bf16: {ms:.4f} ms, {tflops:.1f} TFLOP/s "
              f"(bound {b_ms:.4f} ms by {b_by}, plain {plain_ms:.4f} ms, library (product only) "
              f"{lib_ms:.4f} ms, max abs err {err:.3e})", flush=True)

    def affine(k):
        return (torch.rand(k, generator=gen, device="cuda") + 0.5,
                torch.randn(k, generator=gen, device="cuda") * 0.5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    for shape_name, (m, k, n) in FUSED_1X1_SHAPES.items():
        x, w, dy = randn(m, k, scale=1.5), randn(k, n, scale=0.05), randn(m, n)
        a, b = affine(k)
        z = fc.normalize_relu(x, a, b, torch.bfloat16)
        err = _check_fused("bn_relu_matmul", shape_name, fc.bn_relu_matmul(x, a, b, w),
                           fc.bn_relu_matmul_plain(x, a, b, w, torch.float32),
                           fc.bn_relu_matmul_plain(x, a, b, w.abs(), torch.float32), True)
        record("bn_relu_matmul", shape_name, (m, k, n), err,
               time_ms(lambda: fc.bn_relu_matmul(x, a, b, w), 10),
               time_ms(lambda: fc.bn_relu_matmul_plain(x, a, b, w), 3),
               time_ms(lambda: torch.matmul(z, w), 10),
               2 * (m * k + k * n + m * n) + 8 * k, 2 * m * k * n)
        err = _check_fused("bn_relu_matmul_dw", shape_name, fc.bn_relu_matmul_dw(x, a, b, dy),
                           fc.bn_relu_matmul_dw_plain(x, a, b, dy),
                           fc.bn_relu_matmul_dw_plain(x, a, b, dy.abs()), False)
        record("bn_relu_matmul_dw", shape_name, (m, k, n), err,
               time_ms(lambda: fc.bn_relu_matmul_dw(x, a, b, dy), 10),
               time_ms(lambda: fc.bn_relu_matmul_dw_plain(x, a, b, dy), 3),
               time_ms(lambda: torch.matmul(z.t(), dy), 10),
               2 * (m * k + m * n) + 8 * k + 4 * k * n, 2 * m * k * n)
        del x, w, dy, z

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    for shape_name, (bsz, h, wd, k) in FUSED_3X3_SHAPES.items():
        n, m = k, bsz * h * wd
        x, w, dy = randn(bsz, h, wd, k, scale=1.5), randn(3, 3, k, n, scale=0.05), \
            randn(bsz, h, wd, n)
        a, b = affine(k)
        z = nchw(fc.normalize_relu(x, a, b, torch.bfloat16))
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        err = _check_fused("bn_relu_conv3x3", shape_name, fc3.bn_relu_conv3x3(x, a, b, w),
                           fc3.bn_relu_conv3x3_plain(x, a, b, w, torch.float32),
                           fc3.bn_relu_conv3x3_plain(x, a, b, w.abs(), torch.float32), True)
        record("bn_relu_conv3x3", shape_name, (bsz, h, wd, k, n), err,
               time_ms(lambda: fc3.bn_relu_conv3x3(x, a, b, w), 10),
               time_ms(lambda: fc3.bn_relu_conv3x3_plain(x, a, b, w), 3),
               time_ms(lambda: F.conv2d(z, w_oihw, padding=1), 10),
               2 * (m * k + 9 * k * n + m * n) + 8 * k, 2 * m * 9 * k * n)
        err = _check_fused("conv3x3_dw", shape_name, fc3.conv3x3_dw(x, a, b, dy),
                           fc3.conv3x3_dw_plain(x, a, b, dy),
                           fc3.conv3x3_dw_plain(x, a, b, dy.abs()), False)
        record("conv3x3_dw", shape_name, (bsz, h, wd, k, n), err,
               time_ms(lambda: fc3.conv3x3_dw(x, a, b, dy), 10),
               time_ms(lambda: fc3.conv3x3_dw_plain(x, a, b, dy), 3),
               time_ms(lambda: torch.nn.grad.conv2d_weight(z, (n, k, 3, 3), nchw(dy),
                                                           padding=1), 10),
               2 * (m * k + m * n) + 8 * k + 4 * 9 * k * n, 2 * m * 9 * k * n)
        del x, w, dy, z, w_oihw

    for shape_name, (bsz, h, wd, k) in FUSED_S2_SHAPES.items():
        n, m_out = k, bsz * (h // 2) * (wd // 2)
        x, w = randn(bsz, h, wd, k, scale=1.5), randn(3, 3, k, n, scale=0.05)
        a, b = affine(k)
        z = nchw(fc.normalize_relu(x, a, b, torch.bfloat16))
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        err = _check_fused("bn_relu_conv3x3_s2", shape_name, fc3.bn_relu_conv3x3_s2(x, a, b, w),
                           fc3.bn_relu_conv3x3_s2_plain(x, a, b, w, torch.float32),
                           fc3.bn_relu_conv3x3_s2_plain(x, a, b, w.abs(), torch.float32), True)
        record("bn_relu_conv3x3_s2", shape_name, (bsz, h, wd, k, n), err,
               time_ms(lambda: fc3.bn_relu_conv3x3_s2(x, a, b, w), 10),
               time_ms(lambda: fc3.bn_relu_conv3x3_s2_plain(x, a, b, w), 3),
               time_ms(lambda: F.conv2d(z, w_oihw, stride=2, padding=1), 10),
               2 * (bsz * h * wd * k + 9 * k * n + m_out * n) + 8 * k, 2 * m_out * 9 * k * n)
        del x, w, z, w_oihw
    torch.cuda.empty_cache()
    return report


def check_prefetched(dataset, label: str, trim_h2d: bool = False) -> dict:
    """The first two batches the Prefetcher delivers on the card (4 staging
    workers, depth 2), held while it stages on and recycles its canvases,
    against `get_batch` of the same indices and a plain `.to("cuda")`, bit
    for bit: canvas (its trimmed prefix with `trim_h2d`), labels, extents.
    Returns the count of rot-staged samples, the seconds from the loader's
    start to its first batch on the card (an epoch's first-batch stall), and
    the seconds of each plain `get_batch` (one call, the dataset's own
    decode threads)."""
    import torch

    from moco_tpu_torch.data.loader import epoch_loader, epoch_permutation, trim_extent

    t0 = time.perf_counter()
    loader = epoch_loader(dataset, 0, 0, BATCH, "cuda", depth=2, workers=4,
                          trim_h2d=trim_h2d)
    try:
        it = iter(loader)
        held = [next(it)]
        torch.cuda.synchronize()
        first_batch_s = time.perf_counter() - t0
        held.append(next(it))
        deadline = time.time() + 120
        while loader.qsize() < min(2, len(loader) - 2) and time.time() < deadline:
            time.sleep(0.01)
    finally:
        loader.close_quietly()
    torch.cuda.synchronize()
    order = epoch_permutation(len(dataset), 0, 0, BATCH)
    rot, get_batch_s = 0, []
    for b, (imgs, labels, extents) in enumerate(held):
        t0 = time.perf_counter()
        ref_imgs, ref_labels, ref_extents = dataset.get_batch(order[b * BATCH:(b + 1) * BATCH])
        get_batch_s.append(time.perf_counter() - t0)
        want = torch.from_numpy(ref_imgs).to("cuda")
        if trim_h2d:
            th, tw = trim_extent(ref_imgs.shape, ref_extents)
            if tuple(imgs.shape[1:3]) != (th, tw):
                fail(f"{label}: batch {b} trimmed to {tuple(imgs.shape[1:3])}, expected "
                     f"{(th, tw)}", 1)
            want = want[:, :th, :tw]
        if not (imgs.is_cuda and torch.equal(imgs, want)
                and torch.equal(labels, torch.from_numpy(ref_labels).to("cuda"))
                and torch.equal(extents, torch.from_numpy(ref_extents).to("cuda"))):
            fail(f"{label}: prefetched batch {b} differs from get_batch + .to('cuda')", 1)
        rot += int((extents[:, 2] > 0).sum())
    print(f"{label}: the first 2 prefetched batches {list(held[0][0].shape)} equal "
          f"get_batch + .to('cuda') bit for bit ({rot} rot-staged samples; first batch on "
          f"the card {1e3 * first_batch_s:.1f} ms after the loader's start; get_batch "
          f"{', '.join(f'{1e3 * t:.1f}' for t in get_batch_s)} ms)", flush=True)
    return dict(rot=rot, get_batch_s=get_batch_s, first_batch_s=first_batch_s)


def run_slice(counters: dict, label: str, config, dataset, steps: int) -> dict:
    """`steps` steps of `config` at batch 256 through `train.train`, fed by
    `epoch_loader` (4 staging workers, depth 2, metrics on the host every
    step); then one profiled step. Every kernel's launches must match its
    count per step (the fused family's are 0 unless `fused_bn_conv`). With
    `config.input_prestage` the driver opens the prestage itself (its
    `input_prestage` branch); `dataset` is then that prestage, for the
    profiled step."""
    import torch

    from moco_tpu_torch import train
    from moco_tpu_torch.data.stats import InputPipelineStats

    config = config.replace(batch_size=BATCH, staging_workers=4, prefetch_depth=2,
                            print_freq=1)
    per_epoch = len(dataset) // BATCH
    rows = []

    def on_step(step, metrics, seconds):
        launches = {name: fn.launches for name, fn in counters.items()}
        mem = torch.cuda.max_memory_allocated() / 2**30
        rows.append(dict(step=step, seconds=seconds, launches=launches, **metrics))
        print(f"{label} step {step}: loss {metrics['loss']:.6f} acc1 {metrics['acc1']:.3f} "
              f"lr {metrics['lr']:.6g} queue_ptr {int(metrics['queue_ptr'])} step_s "
              f"{seconds:.4f} imgs_s {BATCH / seconds:.1f} max_mem_gib {mem:.2f} "
              f"launches {launches}", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    blur_routes = counters["gaussian_blur_batch"].routes
    blur_routes.update(fixed=0, generic=0)
    for fn in counters.values():
        fn.launches = 0
    stats = InputPipelineStats()
    state, history = train.train(config, max_steps=steps, device="cuda",
                                 dataset=None if config.input_prestage else dataset,
                                 on_step=on_step, stats=stats)
    launches = {name: fn.launches for name, fn in counters.items()}
    # 224 px views blur at R = 11: every launch on the taps-in-registers route
    if blur_routes != {"fixed": PER_STEP["gaussian_blur_batch"] * steps, "generic": 0}:
        fail(f"{label}: blur routes {blur_routes} in {steps} steps", 1)

    # sync_bn keeps the fused tail off, as the JAX package ignores it under SyncBN
    fused = config.fused_bn_conv and not config.sync_bn
    expected = {**PER_STEP, **{name: per_step if fused else 0
                               for name, per_step in FUSED_PER_STEP.items()}}
    for name, per_step in expected.items():
        if launches[name] != per_step * steps:
            fail(f"{label}: {name} launched {launches[name]} times in {steps} steps, "
                 f"expected {per_step * steps}", 1)
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite or missing losses: {losses}", 1)
    if state.queue_ptr != steps * BATCH % config.num_negatives:
        fail(f"{label}: queue pointer {state.queue_ptr} after {steps} steps", 1)
    norms = state.queue.norm(dim=1)
    if not bool(torch.isfinite(state.queue).all()) or float((norms - 1).abs().max()) > 1e-5:
        fail(f"{label}: queue rows are not finite unit vectors", 1)
    max_memory_gib = torch.cuda.max_memory_allocated() / 2**30
    snap = stats.snapshot()
    busy_ms, wall_ms = profile_step(config, state, dataset, label, counters, expected)
    steady = [r["seconds"] for r in rows[1:]]
    # steps whose batch the loader staged while an earlier step ran (not an
    # epoch's first batch, which each new epoch's loader stages from cold)
    in_epoch = [r["seconds"] for r in rows[1:] if (r["step"] - 1) % per_epoch]
    summary = dict(launches=launches, losses=losses, steady_step_s=sum(steady) / len(steady),
                   in_epoch_step_s=sum(in_epoch) / len(in_epoch) if in_epoch else None,
                   max_memory_gib=max_memory_gib, busy_ms=busy_ms, wall_ms=wall_ms,
                   input=snap)
    summary["imgs_per_s"] = BATCH / summary["steady_step_s"]
    busy_s = snap["worker_busy_frac"] * snap["workers"] * snap["wall_s"]
    in_epoch_text = (f"{BATCH / summary['in_epoch_step_s']:.1f} imgs/s over the "
                     f"{len(in_epoch)} steps fed from a staged-ahead batch"
                     if in_epoch else "no step fed from a staged-ahead batch")
    print(f"{label}: {steps} steps, steady step {summary['steady_step_s']:.4f} s "
          f"({summary['imgs_per_s']:.1f} imgs/s; {in_epoch_text}), peak memory "
          f"{max_memory_gib:.2f} GiB, launches {launches}", flush=True)
    print(f"{label} input: {snap['staged_batches']} batches staged, staging "
          f"{1e3 * snap['staged_batch_s_p50']:.1f} ms p50 / "
          f"{1e3 * snap['staged_batch_s_p95']:.1f} ms p95 a batch, worker decode "
          f"{1e3 * busy_s / max(snap['staged_batches'], 1):.1f} ms a batch (summed over "
          f"{snap['workers']} workers), credit stall {snap['credit_stall_s']:.3f} s, queue "
          f"depth mean {snap['queue_depth_mean']}", flush=True)
    return summary


def profile_step(config, state, dataset, label: str, counters: dict,
                 expected: dict) -> tuple[float, float]:
    """One steady step under torch.profiler, fed by `epoch_loader` with the
    next batch already staged (one unprofiled step first): device time by
    kernel, and the device's busy time against the step's wall time, from
    taking the batch to the metrics on the host. Returns (busy ms, wall ms).

    The wrappers' launch counts of the profiled step must equal `expected`,
    and the device must have run each of the BN pair's and the blur's
    kernels once a launch. More device records than launches (a second
    pass) fail at once. Fewer are a profiler that lost records: one run kept
    57 of a step's 106 `channel_sums_rows` records while the wrappers
    counted 106. Such a trace is reported and another step profiled, up to
    PROFILE_TRIES times; a run with no complete trace fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from moco_tpu_torch.data.augment import aug_config_for, two_crops
    from moco_tpu_torch.data.loader import epoch_loader
    from moco_tpu_torch.train import host_metrics
    from moco_tpu_torch.train_step import build_train_step

    step_fn = build_train_step(config, steps_per_epoch=2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    aug_cfg = aug_config_for(config)
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(1, PROFILE_TRIES + 1):
        loader = epoch_loader(dataset, 98 + attempt, config.seed, BATCH, "cuda",
                              depth=config.prefetch_depth, workers=config.staging_workers,
                              trim_h2d=config.h2d_trim)
        try:
            batches = iter(loader)
            images, _, extents = next(batches)
            host_metrics(step_fn(state, *two_crops(images, aug_cfg, gen, extents)))
            deadline = time.time() + 120
            while loader.qsize() == 0 and time.time() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                images, _, extents = next(batches)
                im_q, im_k = two_crops(images, aug_cfg, gen, extents)
                host_metrics(step_fn(state, im_q, im_k))
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            loader.close_quietly()
        launches = {name: fn.launches for name, fn in counters.items()}
        if launches != expected:
            fail(f"profile {label}: the profiled step launched {launches}, expected {expected}",
                 1)
        records = [e for e in prof.events() if e.device_type == cuda]
        seen = {name: sum(1 for e in records if kernel in e.name)
                for name, kernel in PORT_RECORDS.items()}
        want = {name: launches[name] for name in PORT_RECORDS}
        print(f"profile {label}: attempt {attempt}: {len(records)} device records; port "
              f"kernel records {seen}, launched {want}", flush=True)
        more = {name: n for name, n in seen.items() if n > want[name]}
        if more:
            fail(f"profile {label}: the device ran more port kernels than the wrappers "
                 f"launched: {more} against {want}", 1)
        if seen == want:
            break
        print(f"profile {label}: the profiler lost device records; profiling another step",
              flush=True)
    else:
        if not records:
            print(f"profile {label}: the profiler recorded no device time (not measured)",
                  flush=True)
            return float("nan"), wall_ms
        fail(f"profile {label}: no complete trace in {PROFILE_TRIES} profiled steps", 1)
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    kernel_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernel_events) / 1e3
    print(f"profile {label}: one step, wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle {wall_ms - busy_ms:.2f} ms, "
          f"{len(kernel_events)} kernel names", flush=True)
    categories = {"port kernels": ("channel_sums_rows", "channel_grad_sums_rows", "blur_rows",
                                   "bn_relu_conv_gemm", "conv_dw_partial", "conv3x3_dw_bands",
                                   "sum_slabs", "conv3x3_fwd_bands", "matmul_fwd_panel",
                                   "matmul_dw_rows", "sum_groups"),
                  "convolution": ("conv", "xmma_fprop", "xmma_dgrad", "xmma_wgrad", "cudnn",
                                  "implicit_gemm", "fprop", "dgrad", "wgrad"),
                  "matmul": ("gemm", "cublas", "cutlass"),
                  "elementwise": ("elementwise", "foreach", "multi_tensor"),
                  "reduction": ("reduce", "softmax", "argsort", "sort", "scan")}
    totals = dict.fromkeys([*categories, "other"], 0.0)
    for e in kernel_events:
        name = e.key.lower()
        cat = next((c for c, keys in categories.items() if any(k in name for k in keys)),
                   "other")
        totals[cat] += e.device_time_total / 1e3
    # the BN pair: one launch per call ("channel_sums_rows" is not part of
    # "channel_grad_sums_rows"), and no second pass
    pair = {name: [e for e in kernel_events if f"{name}_rows" in e.key]
            for name in ("channel_sums", "channel_grad_sums")}
    pair = {name: (sum(e.count for e in ev), sum(e.device_time_total for e in ev) / 1e3)
            for name, ev in pair.items()}
    print(f"profile {label} BN pair: " + ", ".join(
        f"{name}_rows {n} launches {ms:.3f} ms" for name, (n, ms) in pair.items()), flush=True)
    for name, (n, _) in pair.items():
        if n != expected[name]:
            fail(f"profile {label}: {name}_rows launched {n} times in one step, expected "
                 f"{expected[name]}", 1)
    if any("sum_partials" in e.key for e in kernel_events):
        fail(f"profile {label}: a second pass (sum_partials) ran", 1)
    blur_ev = [e for e in kernel_events if "blur_rows" in e.key]
    blur_n = sum(e.count for e in blur_ev)
    print(f"profile {label} blur: blur_rows {blur_n} launches "
          f"{sum(e.device_time_total for e in blur_ev) / 1e3:.3f} ms", flush=True)
    if blur_n != expected["gaussian_blur_batch"]:
        fail(f"profile {label}: blur_rows launched {blur_n} times in one step, expected "
             f"{expected['gaussian_blur_batch']}", 1)
    print(f"profile {label} by category (ms): " + ", ".join(
        f"{c} {t:.2f} ({100 * t / busy_ms:.1f}%)" for c, t in totals.items()), flush=True)
    top = sorted(kernel_events, key=lambda e: e.device_time_total, reverse=True)[:15]
    for e in top:
        print(f"profile {label} kernel {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:110]}", flush=True)
    return busy_ms, wall_ms


def write_jpeg_tree(root: Path, seed: int = 0) -> None:
    """IMAGEFOLDER_IMAGES seeded JPEGs over 8 class directories at
    ImageNet-like sizes, both orientations: a smooth random field per image
    (a coarse grid upsampled, as photos are mostly low-frequency) plus
    pixel noise, saved at quality 90."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    jobs = []
    for i in range(IMAGEFOLDER_IMAGES):
        h, w = IMAGEFOLDER_SIZES[i % len(IMAGEFOLDER_SIZES)]
        jobs.append((root / f"n{i % 8:08d}" / f"img_{i:05d}.JPEG", h, w,
                     rng.randint(0, 2**31 - 1)))
    for cls in range(8):
        (root / f"n{cls:08d}").mkdir(parents=True)

    def one(job):
        path, h, w, s = job
        r = np.random.RandomState(s)
        coarse = Image.fromarray((r.rand(h // 32 + 2, w // 32 + 2, 3) * 255).astype(np.uint8))
        img = np.asarray(coarse.resize((w, h), Image.BICUBIC), np.int16)
        img = np.clip(img + r.randint(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(str(path), quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, jobs))


def run_imagefolder(counters: dict) -> dict:
    """Phase 4: imagenet-moco-v2 at batch 256, 224 px, from a generated JPEG
    tree through `ImageFolder` (stage size 512, a [256, 512, 1024, 3] uint8
    canvas a batch) and the Prefetcher; with `h2d_trim` off, then on. Each
    run first holds the first two prefetched batches against a plain copy,
    with rot-staged samples among them. Then phase 6's prestage: the tree
    decoded once into a prestage (`write_prestage`), an epoch's first batch
    of it held byte for byte against the PIL decode of the same images, and
    the same steps from it through the driver's `input_prestage` branch."""
    import tempfile

    import numpy as np

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.data.datasets import ImageFolder
    from moco_tpu_torch.data.loader import epoch_permutation
    from moco_tpu_torch.data.service.prestage import PrestagedDataset, write_prestage

    config = get_preset("imagenet-moco-v2")
    results = {}
    with tempfile.TemporaryDirectory(prefix="moco_imagefolder_") as tmp, \
            tempfile.TemporaryDirectory(prefix="moco_prestage_") as pre_tmp:
        t0 = time.perf_counter()
        write_jpeg_tree(Path(tmp))
        print(f"imagefolder: wrote {IMAGEFOLDER_IMAGES} JPEGs over 8 classes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        dataset = ImageFolder(tmp, stage_size=512, backend=IMAGEFOLDER_BACKEND)
        for trim in (False, True):
            label = "imagefolder_trim" if trim else "imagefolder"
            check = check_prefetched(dataset, label, trim_h2d=trim)
            if check["rot"] == 0:
                fail(f"{label}: no rot-staged sample in the first two batches", 1)
            summary = run_slice(counters, label, config.replace(h2d_trim=trim), dataset,
                                IMAGEFOLDER_STEPS)
            summary.update(get_batch_s=check["get_batch_s"],
                           first_batch_s=check["first_batch_s"])
            results[label] = summary
        # phase 6: the pre-staged epoch cache of the same tree
        root = str(Path(pre_tmp) / "prestage")
        t0 = time.perf_counter()
        meta = write_prestage(dataset, root)
        write_s = time.perf_counter() - t0
        pre = PrestagedDataset(root)
        order = epoch_permutation(len(dataset), 0, 0, BATCH)[:BATCH]
        t0 = time.perf_counter()
        decoded = dataset.get_batch(order)
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = pre.get_batch(order)
        gather_s = time.perf_counter() - t0
        if not all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(served, decoded)):
            fail("prestage: a prestaged batch differs from the PIL decode of its images", 1)
        disk = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
        per_image = disk / meta["n"]
        print(f"prestage: {meta['n']} images decoded once into {disk} bytes on disk "
              f"({per_image:.0f} bytes an image; canvases {meta['canvas_bytes']} bytes, "
              f"{meta['img_shape']} uint8 each) in {write_s:.2f} s; a batch of {BATCH} equals "
              f"the PIL decode byte for byte (get_batch: PIL {1e3 * decode_s:.1f} ms, "
              f"prestage {1e3 * gather_s:.1f} ms)", flush=True)
        check = check_prefetched(pre, "prestage")
        summary = run_slice(counters, "prestage", config.replace(input_prestage=root), pre,
                            IMAGEFOLDER_STEPS)
        summary.update(get_batch_s=check["get_batch_s"], first_batch_s=check["first_batch_s"],
                       disk_bytes=disk, bytes_per_image=per_image, write_s=write_s)
        results["prestage"] = summary
        if dataset.decode_failures:
            fail(f"imagefolder: {dataset.decode_failures} decode failures", 1)
    pil, pre_r = results["imagefolder"], results["prestage"]
    print(f"prestage vs PIL: {pre_r['imgs_per_s']:.1f} vs {pil['imgs_per_s']:.1f} imgs/s, "
          f"first-batch stall {1e3 * pre_r['first_batch_s']:.1f} vs "
          f"{1e3 * pil['first_batch_s']:.1f} ms, credit stall over the run "
          f"{pre_r['input']['credit_stall_s']:.3f} vs {pil['input']['credit_stall_s']:.3f} s; "
          f"{pre_r['bytes_per_image']:.0f} bytes an image, {pre_r['disk_bytes']} bytes on disk",
          flush=True)
    return results


def check_against_cpu(fused: bool = False, counters: dict | None = None) -> None:
    """A 4-stage Bottleneck ResNet (width 16, MLP head) in f32 at 32 px,
    batch 16, on the card (kernels) and on the CPU (plain versions) from the
    same weights and inputs: the train-mode forward, the running statistics,
    and one train step's loss and enqueued keys; then, unfused, one
    FastBatchNorm's forward and gradients at a ResNet-50 shape. With
    `fused=True` the model has `fused_bn_conv=True`, so the card side runs
    the fused kernels (layer 1 at stride 1, layers 2-4 at stride 2), each of
    which must launch.

    The model's parameter gradients are not compared: a ReLU input within
    f32 rounding of zero can take the other sign on the other device (one
    element of 32768 did in a measured run), and the large gradient it
    gates then moves the upstream gradients by a few percent. A ResNet-50
    at this size is worse: a 1e-6 nudge of its weights moves its layer-4
    gradients by ~20%, in the JAX package as well."""
    import numpy as np
    import torch

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.models import resnet
    from moco_tpu_torch.models.fast_bn import FastBatchNorm
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_train_step

    config = get_preset("imagenet-moco-v2").replace(
        compute_dtype="float32", image_size=32, batch_size=16, num_negatives=64,
        fused_bn_conv=fused)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 32, 32, 3).astype(np.float32))
    im_q, im_k = (torch.from_numpy(a) for a in rng.randn(2, 16, 32, 32, 3).astype(np.float32))
    bn_x = torch.from_numpy(rng.randn(32, 64, 28, 28).astype(np.float32) * 2 + 0.5)
    bn_x = bn_x.contiguous(memory_format=torch.channels_last)
    bn_ct = torch.from_numpy(rng.randn(32, 64, 28, 28).astype(np.float32))

    def model():
        return resnet.ResNet((1, 1, 1, 1), resnet.Bottleneck, width=16, num_classes=128,
                             mlp_head=True, generator=torch.Generator().manual_seed(0),
                             fused_bn_conv=fused)

    res = {}
    for dev in ("cpu", "cuda"):
        before = {name: fn.launches for name, fn in (counters or {}).items()}
        m = model().to(dev).train()
        with torch.no_grad():
            tensors = {"out": m(x.to(dev))}
        tensors.update({f"buffer:{n}": b for n, b in m.named_buffers()})
        state = create_train_state(config, model(), dev, seed=0)
        metrics = build_train_step(config, steps_per_epoch=8)(state, im_q.to(dev), im_k.to(dev))
        tensors["step_loss"] = metrics["loss"].reshape(1)
        tensors["enqueued_keys"] = state.queue[:16]
        if not fused:
            bn = FastBatchNorm(64).to(dev)
            xd = bn_x.to(dev, copy=True).requires_grad_()
            y = bn(xd)
            (y * bn_ct.to(dev)).sum().backward()
            tensors.update({"bn:y": y.detach(), "bn:dx": xd.grad, "bn:dweight": bn.weight.grad,
                            "bn:dbias": bn.bias.grad, "bn:running_var": bn.running_var})
        res[dev] = {k: v.detach().cpu() for k, v in tensors.items()}
        idle = [name for name, n in before.items() if counters[name].launches == n]
        if dev == "cuda" and idle:
            fail(f"check: the card side never launched {idle}", 1)
    worst = (0.0, "")
    for key, ref in res["cpu"].items():
        # f32 sums in another order: ~1e-6 of each tensor's largest entry
        err = float((res["cuda"][key] - ref).abs().max() / ref.abs().max().clamp(min=1e-12))
        if err > 1e-4:
            fail(f"card and CPU disagree on {key}{' (fused)' if fused else ''}: {err:.3e} of "
                 f"its largest entry", 1)
        worst = max(worst, (err, key))
    what = ("fused_bn_conv Bottleneck ResNet f32 32px batch 16" if fused else
            "Bottleneck ResNet f32 32px batch 16 and a [32, 64, 28, 28] BN")
    print(f"check: {what}, card vs cpu over {len(res['cpu'])} tensors, worst "
          f"{worst[0]:.3e} ({worst[1]}); step loss {float(res['cuda']['step_loss'][0]):.6f} "
          f"vs {float(res['cpu']['step_loss'][0]):.6f}", flush=True)


NCCL_CALLS = ("all_gather", "all_reduce", "batch_isend_irecv", "all_gather_into_tensor",
              "gather")


def counted_train(config, label: str, counters: dict, dataset, steps: int, device="cuda",
                  finish=None, stats=None) -> dict:
    """`train.train` for `steps` steps of `config` on `dataset`, with the
    logits captured where the step computes them, the NCCL calls and every
    kernel's launches counted (each must launch its per-step count every
    step), and `finish(gradsync, state, run)` called in place of each
    step's `GradSync.finish`, `run()` running it (when given); `stats` an
    `InputPipelineStats` the input pipeline reports to. Returns the
    state, losses, logits, launches, calls, the steps' host seconds and
    imgs/s over steps 2... (rank 0's; NaN on the others)."""
    import torch
    import torch.distributed as dist

    from moco_tpu_torch import train, train_step
    from moco_tpu_torch.parallel.gradsync import GradSync

    captured, seconds = [], []
    calls = dict.fromkeys(NCCL_CALLS, 0)
    real_logits = train_step.infonce_logits
    real_calls = {name: getattr(dist, name) for name in calls}
    real_finish = GradSync.finish

    def capture(*args, **kw):
        out = real_logits(*args, **kw)
        captured.append(out[0].detach().clone())
        return out

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return real_calls[name](*args, **kw)
        return call

    def finish_hooked(self, state):
        finish(self, state, lambda: real_finish(self, state))

    for fn in counters.values():
        fn.launches = 0
    train_step.infonce_logits = capture
    for name in calls:
        setattr(dist, name, counting(name))
    if finish is not None:
        GradSync.finish = finish_hooked
    try:
        state, history = train.train(config, max_steps=steps, device=device, dataset=dataset,
                                     on_step=lambda step, m, sec: seconds.append(sec),
                                     stats=stats)
    finally:
        train_step.infonce_logits = real_logits
        GradSync.finish = real_finish
        for name in calls:
            setattr(dist, name, real_calls[name])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    # sync_bn keeps the fused tail off, as the JAX package ignores it under SyncBN
    fused = config.fused_bn_conv and not config.sync_bn
    expected = {**PER_STEP, **{name: per_step if fused else 0
                               for name, per_step in FUSED_PER_STEP.items()}}
    for name, per_step in expected.items():
        if launches[name] != per_step * steps:
            fail(f"{label}: {name} launched {launches[name]} times in {steps} steps, "
                 f"expected {per_step * steps}", 1)
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite or missing losses {losses}", 1)
    steady = seconds[1:]  # on_step sees rank 0's steps only
    return dict(state=state, losses=losses, logits=captured, launches=launches, calls=calls,
                seconds=seconds, imgs_per_s=(config.batch_size * len(steady) / sum(steady)
                                             if steady else math.nan))


def compare_runs(a: dict, b: dict, label: str, steps: int) -> None:
    """Fail unless two `counted_train` runs are equal bit for bit: losses,
    captured logits, enqueued keys (the queue) and the whole state."""
    import torch

    diff = _states_equal(a["state"], b["state"])
    if a["losses"] != b["losses"]:
        diff.append(f"losses {a['losses']} != {b['losses']}")
    if len(a["logits"]) != len(b["logits"]) or not all(
            torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])):
        diff.append("logits")
    if diff:
        fail(f"{label}: the runs differ in {diff[:6]} (deterministic cuDNN was on, so a "
             "changed algorithm choice or a non-deterministic kernel is the cause)", 1)
    print(f"{label}: equal bit for bit: {steps} losses, {len(a['logits'])} logits "
          f"{list(a['logits'][0].shape)}, {a['state'].queue_ptr} enqueued keys, both "
          "encoders, momentum buffers, generators", flush=True)


def run_distributed(counters: dict, dataset) -> dict:
    """Phase 6: the data-parallel step on the card. One NCCL group of one
    rank (a FileStore in a temporary directory) drives `train.train` for
    DIST_STEPS steps of imagenet-moco-v2 at batch 256, unfused and with
    `fused_bn_conv=True`; each is run again from the same state with no
    group. Under deterministic cuDNN the two runs' losses, logits (captured
    where the step computes them), enqueued keys and whole states must be
    equal bit for bit. Counts the NCCL calls a step, checks every kernel's
    launches, and times the gradient all-reduce. Before the first run the
    TF32 flags are turned on: the entry point must turn them off."""
    import tempfile

    import torch
    import torch.distributed as dist

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, \
        shutdown_distributed

    base = get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", batch_size=BATCH, staging_workers=4, prefetch_depth=2,
        print_freq=1)

    def run(config, label):
        r = counted_train(config, label, counters, dataset, DIST_STEPS)
        print(f"{label}: {DIST_STEPS} steps, losses {[round(v, 6) for v in r['losses']]}, "
              f"{r['imgs_per_s']:.1f} imgs/s (steps 2-{DIST_STEPS}), NCCL calls {r['calls']}, "
              f"launches {r['launches']}", flush=True)
        return r

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        alone = run(base, "phase6 unfused, no group")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail("phase6: train.train left TF32 on; the package's precision policy turns "
                 "it off", 1)
        print("phase6 precision policy: after train.train, cudnn.allow_tf32 "
              f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32 "
              f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
        with tempfile.TemporaryDirectory(prefix="moco_nccl_") as tmp:
            init_distributed("cuda", rank=0, world_size=1,
                             init_method=f"file://{Path(tmp) / 'store'}")
            try:
                grouped = run(base, "phase6 unfused, one-rank NCCL group")
                fused_grouped = run(base.replace(fused_bn_conv=True),
                                    "phase6 fused, one-rank NCCL group")
                want = {**dict.fromkeys(NCCL_CALLS, 0), "all_gather": 2 * DIST_STEPS,
                        "all_reduce": 3 * DIST_STEPS}
                for r in (grouped, fused_grouped):
                    if r["calls"] != want:
                        fail(f"phase6: NCCL calls {r['calls']} in {DIST_STEPS} steps, expected "
                             f"{want} (the key batch and keys gathered; gradients, BN "
                             "statistics and metrics all-reduced)", 1)
                # the fused gradient mean of the last step's gradients, timed alone
                group = process_group()
                params = [p for p in grouped["state"].model_q.parameters()
                          if p.grad is not None]
                sync = GradSync(base, group)
                out["allreduce_ms"] = time_ms(lambda: sync.finish(grouped["state"]), 20)
                out["allreduce_bytes"] = sync.last_bytes
                flat = torch.zeros(sync.last_bytes // 4, device=params[0].device)
                out["nccl_ms"] = time_ms(lambda: dist.all_reduce(flat, group=group), 20)
                out["grad_count"] = sum(p.numel() for p in params)
            finally:
                shutdown_distributed()
        compare_runs(grouped, alone, "phase6 unfused, with and without the group", DIST_STEPS)
        fused_alone = run(base.replace(fused_bn_conv=True), "phase6 fused, no group")
        compare_runs(fused_grouped, fused_alone, "phase6 fused, with and without the group",
                     DIST_STEPS)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out.update(grouped_imgs_s=grouped["imgs_per_s"], alone_imgs_s=alone["imgs_per_s"],
               fused_grouped_imgs_s=fused_grouped["imgs_per_s"],
               fused_alone_imgs_s=fused_alone["imgs_per_s"],
               calls_per_step={k: v / DIST_STEPS for k, v in grouped["calls"].items()})
    print(f"phase6 distributed: one-rank NCCL group vs no group (deterministic cuDNN) "
          f"unfused {out['grouped_imgs_s']:.1f} vs {out['alone_imgs_s']:.1f} imgs/s, fused "
          f"{out['fused_grouped_imgs_s']:.1f} vs {out['fused_alone_imgs_s']:.1f} imgs/s; "
          f"NCCL calls a step {out['calls_per_step']}; gradient all-reduce "
          f"{out['grad_count']} gradients, {out['allreduce_bytes']} bytes, "
          f"{out['allreduce_ms']:.3f} ms a step (flatten, all_reduce, mean, copy back), "
          f"the all_reduce alone {out['nccl_ms']:.3f} ms", flush=True)
    return out


SYNC_STEPS = 3              # phase 7: steps of each gradient-sync run
SYNC_RUNS = (               # (label, config overrides); "fused" is the reference
    ("fused", {}),
    ("bucketed", dict(grad_sync="bucketed")),
    ("quantized int8", dict(grad_sync="quantized")),
    ("quantized bf16", dict(grad_sync="quantized", grad_sync_quant_dtype="bfloat16")),
    ("demo", dict(grad_sync="demo")),
    ("demo cadence 2", dict(grad_sync="demo", grad_sync_cadence=2)),
    ("fused zero_sharding", dict(zero_sharding=True)),
)


def check_rebuild(state, group, wire: str, label: str) -> None:
    """On one rank, `quantized_mean` of the last step's mean plus its
    accumulator must give back its input as mean + error within 1 ulp."""
    import torch

    from moco_tpu_torch.parallel.collectives import quantized_mean

    named = dict(state.model_q.named_parameters())
    segs = [named[k].grad.reshape(-1).float() + a.reshape(-1)
            for k, a in state.gradsync.items()]
    means, errs = quantized_mean(segs, group, wire)
    for s, m, e in zip(segs, means, errs):
        ulp = torch.nextafter(s.abs(), torch.full_like(s, math.inf)) - s.abs()
        if not bool(((m + e - s).abs() <= ulp).all()):
            fail(f"{label}: mean + error misses the input by more than 1 ulp", 1)
    print(f"{label}: mean + error rebuilds the quantized input within 1 ulp: {len(segs)} "
          f"leaves, {sum(s.numel() for s in segs)} values", flush=True)


def run_sync_modes(counters: dict, dataset, group, device) -> dict:
    """Phase 7: the gradient-sync modes and ZeRO-1 on the card, in the
    process group `group` (NCCL over the visible cards; one rank when the
    script runs alone). `train.train` runs SYNC_STEPS steps of
    imagenet-moco-v2 at global batch 256 under deterministic cuDNN for each
    of SYNC_RUNS. For each run: imgs/s, peak memory over what was held
    before it, NCCL calls a step, the reduce's exposed time a step (CUDA
    events from the end of the backward to the end of `GradSync.finish`,
    which waits on every handle), the analytic bytes a step beside what the
    collectives carried, and the accumulators' bytes and largest entry.
    `bucketed` (on 1 or 2 ranks) and `zero_sharding` (on any) must equal
    `fused` bit for bit; quantized and DeMo runs must have finite losses
    and nonzero accumulators; on one rank `mean + error` must rebuild the
    quantized input within 1 ulp and a DeMo sync step's gradient must hold
    exactly k nonzeros a leaf; an off-step's gradient must be all zeros."""
    import torch

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import rank, world_size

    n, me = world_size(group), rank(group)
    base = get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", batch_size=BATCH, staging_workers=4, prefetch_depth=2,
        print_freq=1)
    out, ref = {}, None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, overrides in SYNC_RUNS:
            config = base.replace(**overrides)
            mode = config.grad_sync
            rec = dict(events=[], bytes=[], nnz=[], steps=[])

            def finish(gs, state, real, rec=rec):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                real()
                end.record()
                rec["events"].append((start, end))
                rec["bytes"].append(gs.last_bytes)
                rec["steps"].append(state.step)
                if gs.mode == "demo":
                    rec["nnz"].append(torch.stack([p.grad.count_nonzero()
                                                   for p in state.model_q.parameters()]))

            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            r = counted_train(config, f"phase7 {label}", counters, dataset, SYNC_STEPS,
                              device=device, finish=finish)
            peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
            state = r["state"]
            exposed = [a.elapsed_time(b) for a, b in rec["events"]]
            info = GradSync(config, group).describe(state.model_q.named_parameters())
            acc = state.gradsync
            acc_bytes = sum(t.numel() * t.element_size() for t in acc.values())
            acc_max = max((float(t.abs().max()) for t in acc.values()), default=0.0)
            momentum = (state.optimizer.state_bytes() if config.zero_sharding
                        else sum(v["momentum_buffer"].numel() * 4
                                 for v in state.optimizer.state.values()))
            calls = {k: v / SYNC_STEPS for k, v in r["calls"].items() if v}
            out[label] = dict(imgs_per_s=r["imgs_per_s"], peak_gib=peak_gib, calls=calls,
                              exposed_ms=exposed, info=info, measured_bytes=rec["bytes"],
                              acc_bytes=acc_bytes, acc_max=acc_max, momentum_bytes=momentum,
                              losses=r["losses"])
            if me == 0:
                print(f"phase7 {label}: {r['imgs_per_s']:.1f} imgs/s (steps 2-{SYNC_STEPS}), "
                      f"peak memory {peak_gib:.3f} GiB over the {held / 2**30:.3f} held "
                      f"before, NCCL calls a step {calls}, exposed reduce "
                      f"{[round(v, 3) for v in exposed]} ms a step, bytes a step analytic "
                      f"{info['sync_bytes_per_step']} carried {info['carried_bytes_per_step']} "
                      f"measured {rec['bytes']}, {info.get('buckets', 1)} buckets, "
                      f"accumulators {acc_bytes} bytes largest {acc_max:.6g}, momentum "
                      f"{momentum} bytes on this rank, losses "
                      f"{[round(v, 6) for v in r['losses']]}", flush=True)
            if mode in ("quantized", "demo") and acc_max == 0.0:
                fail(f"phase7 {label}: the accumulators are all zero", 1)
            if mode == "quantized" and n == 1:
                check_rebuild(state, group, config.grad_sync_quant_dtype, f"phase7 {label}")
            if mode == "demo":
                ks = torch.tensor([max(1, math.ceil(p.numel() * config.grad_sync_topk))
                                   for p in state.model_q.parameters()],
                                  device=rec["nnz"][0].device)
                for step, nnz in zip(rec["steps"], rec["nnz"]):
                    if step % config.grad_sync_cadence:
                        ok = not bool(nnz.any())
                    elif n == 1:
                        ok = torch.equal(nnz, ks)
                    else:
                        ok = bool(((nnz >= ks) & (nnz <= n * ks)).all())
                    if not ok:
                        fail(f"phase7 {label}: step {step}'s gradient has {nnz.tolist()} "
                             f"nonzeros a leaf, k = {ks.tolist()}", 1)
                if me == 0:
                    print(f"phase7 {label}: each sync step's gradient held "
                          f"{'exactly' if n == 1 else 'k to n*k:'} k = {int(ks.sum())} "
                          f"nonzeros over {len(ks)} leaves"
                          + ("; each off-step's was all zeros"
                             if config.grad_sync_cadence > 1 else ""), flush=True)
            if label == "fused":
                ref = r
            elif label == "fused zero_sharding" or (label == "bucketed" and n <= 2):
                compare_runs(ref, r, f"phase7 {label} vs fused, {n} rank(s)", SYNC_STEPS)
            elif label == "bucketed":
                # over 2 ranks NCCL sums each element in an order set by its
                # offset, and the buckets lay the gradients out otherwise:
                # only the first loss, before any update, must agree
                if r["losses"][0] != ref["losses"][0]:
                    fail("phase7 bucketed: the first loss differs from fused's", 1)
                if me == 0:
                    print(f"phase7 bucketed vs fused, {n} ranks: first losses equal, then "
                          f"{r['losses']} vs {ref['losses']}", flush=True)
            del r, state, acc
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["sharded_optimizers"] = check_sharded_optimizers(group, device, "phase7")
    return out


def sync_modes_in_group(counters: dict, dataset) -> dict:
    """Phase 7 in its own NCCL group: torchrun's (every visible card, one
    process each) when the script runs under it, else one rank over a
    FileStore in a temporary directory, as phase 6 joins it."""
    import tempfile

    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, \
        shutdown_distributed

    with tempfile.TemporaryDirectory(prefix="moco_nccl_") as tmp:
        if "WORLD_SIZE" in os.environ:
            device = init_distributed("cuda")
        else:
            device = init_distributed("cuda", rank=0, world_size=1,
                                      init_method=f"file://{Path(tmp) / 'store'}")
        try:
            return run_sync_modes(counters, dataset, process_group(), device)
        finally:
            shutdown_distributed()


class _Head:
    """The first `n` samples of a dataset."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n, self.num_classes = dataset, n, dataset.num_classes

    def __len__(self) -> int:
        return self.n

    def get_batch(self, indices):
        return self.dataset.get_batch(indices)


def _cuda_time(fn):
    """(fn's result, its host seconds with the device drained on both ends)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _states_equal(a, b) -> list[str]:
    """The names of what differs between two TrainStates, bit for bit."""
    import torch

    diff = []
    for name in ("model_q", "model_k"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        diff += [f"{name}.{k}" for k in sb if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    if oa["state"].keys() != ob["state"].keys() or not ob["state"]:
        diff.append("optimizer state")
    diff += [f"momentum_buffer {i}" for i in ob["state"] if i in oa["state"] and not
             torch.equal(oa["state"][i]["momentum_buffer"], ob["state"][i]["momentum_buffer"])]
    if not torch.equal(a.queue, b.queue):
        diff.append("queue")
    if (a.step, a.queue_ptr) != (b.step, b.queue_ptr):
        diff.append(f"step/queue_ptr {(a.step, a.queue_ptr)} != {(b.step, b.queue_ptr)}")
    for g in ("generator", "data_generator"):
        if not torch.equal(getattr(a, g).get_state(), getattr(b, g).get_state()):
            diff.append(g)
    return diff


def _step_logits(config, state, images, extents):
    """One more train step of `state` on a fixed batch: (loss, logits,
    enqueued keys), the logits captured where the step computes them."""
    import torch

    from moco_tpu_torch import train_step
    from moco_tpu_torch.data.augment import aug_config_for, two_crops

    captured = []
    real = train_step.infonce_logits

    def capture(*args, **kw):
        out = real(*args, **kw)
        captured.append(out[0].detach().clone())
        return out

    train_step.infonce_logits = capture
    try:
        step_fn = train_step.build_train_step(config, steps_per_epoch=PHASE5_BANK // BATCH)
        im_q, im_k = two_crops(images, aug_config_for(config), state.data_generator, extents)
        ptr = state.queue_ptr
        metrics = step_fn(state, im_q, im_k)
    finally:
        train_step.infonce_logits = real
    torch.cuda.synchronize()
    return metrics["loss"].clone(), captured[0], state.queue[ptr:ptr + BATCH].clone()


def run_checkpoint_and_evals(counters: dict, smi: str) -> dict:
    """Phase 5, on the card at ResNet-50's full width (224 px, batch 256,
    2048-d features, a 1000-class probe): pretrain 2 steps and save, resume
    into a fresh state (every tensor, both generators, the queue pointer
    and the step bit for bit), one more step of each under deterministic
    cuDNN (loss, logits and enqueued keys equal); export `encoder_q` to
    .npz and `load_for_inference` it; encode a 4096-image bank and 1024
    queries and run the streamed kNN, held against the CPU; train the
    linear probe, checkpoint, resume, validate, `--evaluate`,
    `sanity_check`. Times the encode, the probe step, one save and one
    restore."""
    import tempfile

    import numpy as np
    import torch

    from moco_tpu_torch import checkpoint as ckpt
    from moco_tpu_torch import train
    from moco_tpu_torch.config import EvalConfig, get_preset
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.evals import lincls
    from moco_tpu_torch.evals.knn import encode_dataset
    from moco_tpu_torch.ops import knn
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder

    out = {}
    t0 = time.perf_counter()
    bank_set = SyntheticDataset(num_samples=PHASE5_BANK, image_size=224, seed=0)
    query_set = SyntheticDataset(num_samples=PHASE5_QUERIES, image_size=224, seed=999)
    print(f"phase5: {PHASE5_BANK} + {PHASE5_QUERIES} synthetic 224 px images in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="moco_phase5_") as tmp:
        tmp = Path(tmp)
        # 1. pretrain and save, resume into a fresh state
        config = get_preset("imagenet-moco-v2").replace(
            dataset="synthetic", batch_size=BATCH, staging_workers=4, prefetch_depth=2,
            print_freq=1, ckpt_dir=str(tmp / "ckpt"))
        for fn in counters.values():
            fn.launches = 0
        state, history = train.train(config, max_steps=2, device="cuda", dataset=bank_set,
                                     on_step=lambda *a: None)
        launches = {name: fn.launches for name, fn in counters.items()}
        for name in PER_STEP:
            if launches[name] != PER_STEP[name] * 2:
                fail(f"phase5 pretrain: {name} launched {launches[name]} times in 2 steps", 1)
        mgr = ckpt.checkpoint_manager(config.ckpt_dir)
        if mgr.all_steps() != [2] or ckpt.read_position(config.ckpt_dir, 2) != (0, 2):
            fail(f"phase5: the run saved {mgr.all_steps()} at "
                 f"{ckpt.read_position(config.ckpt_dir, 2)}, expected [2] at (0, 2)", 1)
        _, save_s = _cuda_time(lambda: ckpt.save_checkpoint(mgr, state, 2, position=(0, 2)))
        save_bytes = os.path.getsize(os.path.join(mgr.step_dir(2), ckpt.STATE_FILE))
        fresh = create_train_state(config, build_encoder(config), "cuda", seed=config.seed + 1)
        if not _states_equal(fresh, state):
            fail("phase5: the fresh state already equals the saved one", 1)
        _, restore_s = _cuda_time(lambda: ckpt.maybe_resume(mgr, fresh, "auto"))
        diff = _states_equal(fresh, state)
        if diff:
            fail(f"phase5: the restored state differs from the saved one: {diff[:5]}", 1)
        print(f"phase5 resume: steps {[round(h['loss'], 6) for h in history]} losses; "
              f"step {fresh.step}, queue_ptr {fresh.queue_ptr}, "
              f"{len(fresh.model_q.state_dict()) + len(fresh.model_k.state_dict())} encoder "
              "tensors, the momentum buffers, the queue and both generator states equal "
              "the saved ones bit for bit", flush=True)
        # one more step of each from the same batch: cuDNN on deterministic
        # algorithms (benchmark off), so the two forwards must agree bit for bit
        images, _, extents = (torch.from_numpy(a).to("cuda")
                              for a in bank_set.get_batch(np.arange(2 * BATCH, 3 * BATCH)))
        flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            ref = _step_logits(config, state, images, extents)
            got = _step_logits(config, fresh, images, extents)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        for name, a, b in zip(("loss", "logits", "enqueued keys"), got, ref):
            if not torch.equal(a, b):
                fail(f"phase5: the resumed step's {name} differ from the original's by "
                     f"{float((a - b).abs().max()):.3e}", 1)
        print(f"phase5 resumed step: loss {float(got[0]):.6f}, logits {list(got[1].shape)} "
              "and enqueued keys equal the original state's bit for bit "
              "(cudnn.deterministic)", flush=True)
        out.update(save_s=save_s, restore_s=restore_s, save_bytes=save_bytes)
        # 2. export and surgery
        enc = str(tmp / "encoder_q.npz")
        flat = ckpt.export_encoder_q(state, enc)
        del state, fresh, mgr
        torch.cuda.empty_cache()
        model = ckpt.load_for_inference(enc, "resnet50", device="cuda")
        print(f"phase5 export: {len(flat)} tensors in the reference dialect, "
              f"{os.path.getsize(enc) / 2**20:.1f} MiB; surgery for resnet50 kept "
              f"{len(model.state_dict())} backbone tensors", flush=True)
        # 3. kNN: a 4096-image bank, 1024 queries, the bank streamed in chunks
        for fn in counters.values():
            fn.launches = 0
        eval_cfg = EvalConfig(image_size=224)
        (queries, qlabels), _ = _cuda_time(lambda: encode_dataset(model, query_set, eval_cfg))
        (bank, bank_labels), encode_s = _cuda_time(
            lambda: encode_dataset(model, bank_set, eval_cfg))
        if queries.shape != (PHASE5_QUERIES, 2048) or bank.shape != (PHASE5_BANK, 2048) \
                or not bool(torch.isfinite(bank).all() & torch.isfinite(queries).all()):
            fail(f"phase5 kNN: features {tuple(bank.shape)} / {tuple(queries.shape)}, or not "
                 "finite", 1)
        cpu_model = ckpt.load_for_inference(enc, "resnet50", device="cpu")
        idx = np.arange(PHASE5_CPU_FEATURES)
        cpu_feats, _ = encode_dataset(cpu_model, bank_set, eval_cfg, indices=idx)
        feat_err = float((bank[:PHASE5_CPU_FEATURES].cpu() - cpu_feats).abs().max())
        if feat_err > FEATURE_ATOL:
            fail(f"phase5 kNN: card and CPU features differ by {feat_err:.3e}", 1)
        args = dict(num_classes=bank_set.num_classes, k=200, temperature=0.07)
        acc, knn_s = _cuda_time(lambda: knn.knn_accuracy(
            queries, qlabels, bank, bank_labels, batch=512, bank_chunk=PHASE5_CHUNK, **args))
        fq, fb = knn.l2_normalize(queries), knn.l2_normalize(bank)
        pred = knn._knn_predict_prenormalized(fq, fb, bank_labels, bank_chunk=PHASE5_CHUNK,
                                              **args).cpu()
        fq, fb, lb = fq.cpu(), fb.cpu(), bank_labels.cpu()
        pred_cpu = knn._knn_predict_prenormalized(fq, fb, lb, bank_chunk=PHASE5_CHUNK, **args)
        acc_cpu = knn.knn_accuracy(fq, qlabels.cpu(), fb, lb, batch=512,
                                   bank_chunk=PHASE5_CHUNK, **args)
        # ties: the two devices' similarities (the same chunked products as
        # the streamed kNN) differ by at most `delta`; a k-th neighbour within
        # 2 delta of the next, or two best class votes within 2 delta / T of
        # each other, can order either way
        def chunked_sims(a, b):
            return torch.cat([a @ b[i:i + PHASE5_CHUNK].t()
                              for i in range(0, len(b), PHASE5_CHUNK)], dim=1)

        sims = chunked_sims(fq, fb)
        delta = float((chunked_sims(knn.l2_normalize(queries), knn.l2_normalize(bank)).cpu()
                       - sims).abs().max())
        top = sims.topk(201, dim=1)
        kth_tie = (top.values[:, 199] - top.values[:, 200]) <= 2 * delta
        votes = torch.zeros(len(fq), args["num_classes"]).scatter_add_(
            1, lb[top.indices[:, :200]], torch.exp(top.values[:, :200] / 0.07))
        best2 = votes.topk(2, dim=1).values
        vote_tie = (best2[:, 0] - best2[:, 1]) <= best2[:, 0] * 2 * delta / 0.07
        differ = pred != pred_cpu
        if bool((differ & ~(kth_tie | vote_tie)).any()):
            fail(f"phase5 kNN: {int(differ.sum())} predictions differ between card and CPU, "
                 f"{int((differ & ~(kth_tie | vote_tie)).sum())} of them with no tie", 1)
        print(f"phase5 kNN: bank {PHASE5_BANK} and {PHASE5_QUERIES} queries, 2048-d, k=200, "
              f"T=0.07, bank_chunk {PHASE5_CHUNK}: top-1 {100 * acc:.2f}% on the card, "
              f"{100 * acc_cpu:.2f}% on the CPU from the card's features; predictions "
              f"differing {int(differ.sum())}, k-th neighbour ties {int(kth_tie.sum())}, "
              f"vote ties {int(vote_tie.sum())} (device similarities within {delta:.2e}); "
              f"card vs CPU features on {PHASE5_CPU_FEATURES} bank images max abs err "
              f"{feat_err:.3e} (tolerance {FEATURE_ATOL:g})", flush=True)
        out.update(encode_s=encode_s, knn_s=knn_s, knn_top1=acc, feat_err=feat_err,
                   knn_ties=int(kth_tie.sum()), knn_differ=int(differ.sum()))
        del model, cpu_model, bank, queries
        torch.cuda.empty_cache()
        # 4. the linear probe: one epoch, a probe checkpoint, a resumed
        # second epoch, validation after each, sanity_check, --evaluate
        probe = EvalConfig(pretrained=enc, arch="resnet50", dataset="synthetic",
                           image_size=224, num_classes=1000, batch_size=BATCH, epochs=2,
                           print_freq=1, ckpt_dir=str(tmp / "probe"))
        train_set = _Head(bank_set, PHASE5_PROBE_STEPS * BATCH)
        stamps = []

        def on_step(step, metrics):
            stamps.append((step, time.perf_counter(), metrics["loss"]))

        def evaluate():
            return lincls.train_lincls(probe.replace(resume="auto", evaluate=True),
                                       device="cuda", dataset=train_set,
                                       val_dataset=query_set)[1]

        # epoch 0, --evaluate of its checkpoint, epoch 1 resumed from it,
        # --evaluate again: best acc@1 is the larger of the two epochs'
        _, first = lincls.train_lincls(probe, max_steps=PHASE5_PROBE_STEPS, device="cuda",
                                       dataset=train_set, val_dataset=query_set,
                                       on_step=on_step)
        eval_first = evaluate()
        _, best = lincls.train_lincls(probe.replace(resume="auto"),
                                      max_steps=2 * PHASE5_PROBE_STEPS, device="cuda",
                                      dataset=train_set, val_dataset=query_set,
                                      on_step=on_step)
        eval_last = evaluate()
        accs = [first, eval_last]
        if eval_first != first or best != max(first, eval_last):
            fail(f"phase5 probe: --evaluate gave {eval_first} and {eval_last} against the "
                 f"runs' {first} and best {best}", 1)
        steps = [s for s, _, _ in stamps]
        if steps != list(range(1, 2 * PHASE5_PROBE_STEPS + 1)):
            fail(f"phase5 probe: steps {steps}, expected 1..{2 * PHASE5_PROBE_STEPS}", 1)
        if ckpt.checkpoint_manager(probe.ckpt_dir).all_steps() != [PHASE5_PROBE_STEPS,
                                                                   2 * PHASE5_PROBE_STEPS]:
            fail("phase5 probe: checkpoints "
                 f"{ckpt.checkpoint_manager(probe.ckpt_dir).all_steps()}", 1)
        losses = [loss for _, _, loss in stamps]
        if not all(math.isfinite(v) for v in losses):
            fail(f"phase5 probe: non-finite losses {losses}", 1)
        gaps = [b[1] - a[1] for a, b in zip(stamps, stamps[1:]) if b[0] % PHASE5_PROBE_STEPS
                != 1]
        probe_s = sum(gaps) / len(gaps)
        launches = {name: fn.launches for name, fn in counters.items() if fn.launches}
        if launches:
            fail(f"phase5: the eval path launched {launches}; eval-mode BN and the eval "
                 "transforms run no port kernel", 1)
        print(f"phase5 probe: {2 * PHASE5_PROBE_STEPS} steps at batch {BATCH}, 1000 classes "
              f"(losses {', '.join(f'{v:.4f}' for v in losses)}), val acc@1 after each epoch "
              f"{accs} (epoch 1 resumed from epoch 0's checkpoint; --evaluate of each "
              "checkpoint gives the same), sanity_check passed against the file after each "
              "run", flush=True)
        out.update(probe_s=probe_s, probe_acc1=accs)
    print(f"phase5 timings ({smi}): encode_dataset {PHASE5_BANK / out['encode_s']:.1f} imgs/s "
          f"({out['encode_s']:.3f} s for {PHASE5_BANK}); kNN {out['knn_s']:.3f} s; probe train "
          f"step {BATCH / out['probe_s']:.1f} imgs/s ({1e3 * out['probe_s']:.1f} ms a step, "
          f"host clock, print every step); full-state save {out['save_s']:.3f} s, "
          f"{out['save_bytes']} bytes; restore {out['restore_s']:.3f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the MoCo-v3 path
# ---------------------------------------------------------------------------

V3_BATCH = 512              # (a) ViT-S/16: the preset's 4096 over its 8-chip reference
V3_STEPS = 4                # (a): steps through train.train, then one profiled step
V3_R50_BATCH = 256          # (b) ResNet-50 leg
V3_R50_STEPS = 3
V3_CPU_BATCH = 16           # (c) card vs CPU
V3_GROUP_BATCH = 128        # (e) one-rank NCCL group vs no group
V3_GROUP_STEPS = 3
V3_PROBE_STEPS = 4          # (d) imagenet-lincls-v3 probe steps on the export
V3_RANK_BATCH = 1024        # --phase8 under torchrun: the preset's 4096 over four cards
# launches a v3 step: the blur on view 1 (after normalize) and on view 2
# (before solarize); the ResNet-50 leg's 53 BNs in four forwards (k1, k2,
# q1, q2) and the backward of the two query forwards
V3_VIT_PER_STEP = {"gaussian_blur_batch": 2}
V3_R50_PER_STEP = {"channel_sums": 4 * 53, "channel_grad_sums": 2 * 53,
                   "gaussian_blur_batch": 2}
V3_CPU_RTOL = 1e-4          # (c): of each tensor's largest entry (f32 sums in other orders)
V3_GRAD_RTOL = 1e-3         # (c): gradient norms
# (c): the views. The crop's source positions run to 224 in f32, where one
# ulp is 1.5e-5, and resample a little differently on the two devices: on
# an H100 the views differ by 1.1e-4 / 1.8e-4 of their largest entry, and
# by as much with identity taps, before any blur (both printed by (c)). A
# wrong blur must land beyond 10x this: the control in `run_v3` checks it.
V3_VIEW_RTOL = 5e-4
# the attention core: the q.k and p.v batched products and the softmax, both ways
ATTENTION_OPS = ("aten::bmm", "aten::_softmax", "aten::_softmax_backward_data")


class _Repeat:
    """`n` samples cycling through a dataset's."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n, self.num_classes = dataset, n, dataset.num_classes

    def __len__(self) -> int:
        return self.n

    def get_batch(self, indices):
        import numpy as np

        return self.dataset.get_batch(np.asarray(indices) % len(self.dataset))


def _v3_train(config, label: str, counters: dict, dataset, steps: int,
              per_step: dict, calls: dict | None = None, device="cuda") -> dict:
    """`train.train` for `steps` steps of a v3 config, every print step's
    metrics kept; each kernel's launches must be its per-step count (0 for
    one not in `per_step`) times `steps`. `calls`: NCCL call names to count
    (in place)."""
    import torch
    import torch.distributed as dist

    from moco_tpu_torch import train
    from moco_tpu_torch.data import augment

    rows = []
    kernel, seen = augment.gaussian_blur_batch, []
    first = per_step.get("gaussian_blur_batch", 0)

    def blur_kept(images, taps, radius):
        # the path's own call; the first step's launches kept on the host
        out = kernel(images, taps, radius)
        if len(seen) < first:
            seen.append((images.cpu(), taps.cpu(), radius, out.cpu()))
        return out

    def on_step(step, metrics, seconds):
        rows.append(dict(step=step, seconds=seconds, **metrics))
        print(f"{label} step {step}: loss {metrics['loss']:.6f} acc1 {metrics['acc1']:.3f} "
              f"pos_sim {metrics['pos_sim']:.4f} lr {metrics['lr']:.6g} momentum "
              f"{metrics['momentum']:.6f} step_s {seconds:.4f} imgs_s "
              f"{config.batch_size / seconds:.1f}", flush=True)

    real = {name: getattr(dist, name) for name in (calls or {})}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return call

    for fn in counters.values():
        fn.launches = 0
    for name in real:
        setattr(dist, name, counting(name))
    augment.gaussian_blur_batch = blur_kept
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, history = train.train(config, max_steps=steps, device=device, dataset=dataset,
                                     on_step=on_step)
    finally:
        augment.gaussian_blur_batch = kernel
        for name, fn in real.items():
            setattr(dist, name, fn)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name in counters:
        if launches[name] != per_step.get(name, 0) * steps:
            fail(f"{label}: {name} launched {launches[name]} times in {steps} steps, expected "
                 f"{per_step.get(name, 0) * steps}", 1)
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite or missing losses {losses}", 1)
    steady = [r["seconds"] for r in rows[1:]]
    max_memory_gib = torch.cuda.max_memory_allocated() / 2**30
    if len(seen) != first:
        fail(f"{label}: kept {len(seen)} blur launches of the first step, expected {first}", 1)
    blur = _hold_blur(seen, label, device)
    return dict(state=state, losses=losses, launches=launches, rows=rows, blur=blur,
                max_memory_gib=max_memory_gib,
                imgs_per_s=(config.batch_size * len(steady) / sum(steady)
                            if steady else math.nan))


def _hold_blur(seen: list, label: str, device) -> list[dict]:
    """A v3 run's blur launches on their own inputs (`_v3_train` keeps the
    first step's: view 1's normalized image, view 2's [0, 1] image before
    solarize), each output against the f32 plain version on the same input
    and taps: every value within one bf16 ulp (`check_blur_kernel`'s rule),
    the samples whose taps are the identity unchanged."""
    import torch

    from moco_tpu_torch.ops import blur

    out = []
    for i, (images, taps, radius, got) in enumerate(seen):
        images, taps, got = images.to(device), taps.to(device), got.to(device)
        if got.dtype != torch.bfloat16 or got.shape != images.shape:
            fail(f"{label}: blur launch {i + 1} gave {got.dtype} {list(got.shape)} for "
                 f"{images.dtype} {list(images.shape)}, expected bf16 of the input's shape", 1)
        ref = blur.gaussian_blur_batch_plain(images.float(), taps, radius)
        diff = (got.float() - ref).abs()
        bad = int((diff > bf16_ulp(ref)).sum())
        if bad:
            fail(f"{label}: blur launch {i + 1} {list(images.shape)} disagrees with its plain "
                 f"version on the path's own input: {bad} values beyond one bf16 ulp (max abs "
                 f"{float(diff.max()):.3e})", 1)
        ident = identity_rows(taps, radius)
        if not torch.equal(got[ident], images[ident]):
            fail(f"{label}: blur launch {i + 1} changed a sample whose taps are the identity", 1)
        out.append(dict(shape=list(images.shape), lo=float(images.min()),
                        hi=float(images.max()), blurred=int((~ident).sum()),
                        max_abs_err=float(diff.max())))
        del ref, diff
    torch.cuda.empty_cache()
    print(f"{label}: the blur on the path's own inputs, first step, within one bf16 ulp of "
          f"the f32 plain version: " + "; ".join(
              f"view {i + 1} {r['shape']} in [{r['lo']:.4f}, {r['hi']:.4f}], {r['blurred']} "
              f"samples blurred, max abs err {r['max_abs_err']:.3e}"
              for i, r in enumerate(out)), flush=True)
    return out


def _v3_profile(config, state, dataset, label: str, counters: dict, per_step: dict,
                device="cuda") -> dict:
    """One steady v3 step under torch.profiler (an unprofiled one first),
    fed by `epoch_loader` with its batch staged: device busy against the
    step's wall time (from taking the batch to the metrics on the host),
    time by category and the attention core's share. In a process group,
    this process's rows of the global batch, as `train.train` runs them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from moco_tpu_torch.data.augment import aug_config_for, two_crops
    from moco_tpu_torch.data.loader import epoch_loader
    from moco_tpu_torch.parallel.mesh import process_group, rank, world_size
    from moco_tpu_torch.train import host_metrics
    from moco_tpu_torch.train_step import build_train_step

    group = process_group()
    n, me = world_size(group), rank(group)
    b = config.batch_size
    local = b // n
    rows = None if group is None else (me * local, b)
    step_fn = build_train_step(config, steps_per_epoch=len(dataset) // b, group=group)
    gen = torch.Generator(device=device).manual_seed(7)
    aug_cfg = aug_config_for(config)
    loader = epoch_loader(dataset, 99, config.seed, b, device, depth=2, workers=4,
                          num_processes=n, process_index=me)
    try:
        batches = iter(loader)
        images, _, extents = next(batches)
        host_metrics(step_fn(state, *two_crops(images, aug_cfg, gen, extents, rows)))
        deadline = time.time() + 120
        while loader.qsize() == 0 and time.time() < deadline:
            time.sleep(0.01)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            images, _, extents = next(batches)
            x1, x2 = two_crops(images, aug_cfg, gen, extents, rows)
            metrics = host_metrics(step_fn(state, x1, x2))
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        loader.close_quietly()
    launches = {name: fn.launches for name, fn in counters.items()}
    if any(launches[name] != per_step.get(name, 0) for name in counters):
        fail(f"{label} profile: the profiled step launched {launches}, expected {per_step}", 1)
    if not math.isfinite(metrics["loss"]):
        fail(f"{label} profile: loss {metrics['loss']}", 1)
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if not kernels:
        print(f"{label} profile: the profiler recorded no device time (not measured)",
              flush=True)
        return dict(busy_ms=math.nan, wall_ms=wall_ms, attention_ms=math.nan)
    categories = {"port kernels": ("channel_sums_rows", "channel_grad_sums_rows", "blur_rows"),
                  "matmul": ("gemm", "cublas", "cutlass", "sm90_xmma", "nvjet"),
                  "softmax": ("softmax",),
                  "layer norm": ("layer_norm", "layernorm"),
                  "convolution": ("conv", "cudnn", "fprop", "dgrad", "wgrad"),
                  "elementwise": ("elementwise", "foreach", "multi_tensor"),
                  "reduction": ("reduce", "sort", "scan")}
    totals = dict.fromkeys([*categories, "other"], 0.0)
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, keys in categories.items() if any(k in name for k in keys)),
                   "other")
        totals[cat] += e.device_time_total / 1e3
    attention_ms = sum(e.self_device_time_total for e in events
                       if e.key in ATTENTION_OPS) / 1e3
    blur = [e for e in kernels if "blur_rows" in e.key]
    print(f"{label} profile: one step, wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle {wall_ms - busy_ms:.2f} ms; blur_rows "
          f"{sum(e.count for e in blur)} launches {sum(e.device_time_total for e in blur) / 1e3:.3f}"
          f" ms; attention core (bmm + softmax, both ways) {attention_ms:.2f} ms "
          f"({100 * attention_ms / busy_ms:.1f}%)", flush=True)
    print(f"{label} profile by category (ms): " + ", ".join(
        f"{c} {t:.2f} ({100 * t / busy_ms:.1f}%)" for c, t in totals.items()), flush=True)
    for e in sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:12]:
        print(f"{label} profile kernel {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:110]}", flush=True)
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, attention_ms=attention_ms,
                categories=totals)


def _v3_vits(counters: dict, dataset, batch: int, steps: int, label: str,
             remat: bool = False, device="cuda") -> tuple:
    """(a): `imagenet-moco-v3-vits` at `batch` for `steps` steps and a
    profiled one."""
    from moco_tpu_torch.config import get_preset

    config = get_preset("imagenet-moco-v3-vits").replace(
        dataset="synthetic", batch_size=batch, staging_workers=4, prefetch_depth=2,
        print_freq=1, remat=remat)
    data = _Repeat(dataset, batch * (steps + 1))
    r = _v3_train(config, label, counters, data, steps, V3_VIT_PER_STEP, device=device)
    prof = _v3_profile(config, r["state"], data, label, counters, V3_VIT_PER_STEP, device)
    return config, r, prof


def _time_adamw(state, label: str) -> dict:
    """The port's AdamW (`ops/optim.py`, optax's f32 bias corrections) and
    `torch.optim.AdamW(fused=True)` (one fused kernel, f64 corrections),
    each stepping its own copy of `state`'s optimized parameters with the
    same gradients: ms a step (CUDA events) against the bound, each
    parameter, gradient and both moments read once and the parameter and
    moments written once (7 x 4 bytes a parameter)."""
    import torch

    from moco_tpu_torch.ops.optim import AdamW

    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    gen = torch.Generator(device=params[0].device).manual_seed(5)
    grads = [torch.randn(p.shape, generator=gen, device=p.device) * 1e-3 for p in params]

    def copies():
        ps = [p.detach().clone().requires_grad_() for p in params]
        for p, g in zip(ps, grads):
            p.grad = g
        return ps

    own = AdamW(copies(), lr=1e-4, weight_decay=0.1)
    fused = torch.optim.AdamW(copies(), lr=1e-4, weight_decay=0.1, fused=True)
    n = sum(p.numel() for p in params)
    r = dict(parameters=n, tensors=len(params), own_ms=time_ms(own.step, 20),
             fused_ms=time_ms(fused.step, 20), bound_ms=bound(7 * 4 * n, 0)[0])
    print(f"{label} AdamW over {n} parameters in {len(params)} tensors: the port's "
          f"{r['own_ms']:.4f} ms a step, torch.optim.AdamW(fused=True) {r['fused_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms (bytes)", flush=True)
    del own, fused, grads
    torch.cuda.empty_cache()
    return r


def run_v3(counters: dict, dataset, smi: str) -> dict:
    """Phase 8, the MoCo-v3 path on the card (see the module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from moco_tpu_torch import checkpoint as ckpt
    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.data.augment import apply_view, sample_view, v3_aug_configs
    from moco_tpu_torch.evals import lincls
    from moco_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    out = {}
    # (a) ViT-S/16 at full width and depth, bf16, AdamW, the ramp, the pair
    config, r, prof = _v3_vits(counters, dataset, V3_BATCH, V3_STEPS, "phase8 vits")
    out["vits"] = dict(batch=V3_BATCH, remat=config.remat, imgs_per_s=r["imgs_per_s"],
                       max_memory_gib=r["max_memory_gib"], losses=r["losses"],
                       blur_per_step=r["launches"]["gaussian_blur_batch"] / V3_STEPS, **{
                           k: prof[k] for k in ("busy_ms", "wall_ms", "attention_ms")})
    print(f"phase8 vits: ViT-S/16 224 px bf16 batch {V3_BATCH} (remat {config.remat}), "
          f"{r['imgs_per_s']:.1f} imgs/s over steps 2-{V3_STEPS}, peak memory "
          f"{r['max_memory_gib']:.2f} GiB, profiled step busy/wall {prof['busy_ms']:.2f}/"
          f"{prof['wall_ms']:.2f} ms, blur launches a step "
          f"{out['vits']['blur_per_step']:.0f} ({smi})", flush=True)
    vits_state = r["state"]
    out["vits"]["blur"] = r["blur"]
    out["adamw"] = _time_adamw(vits_state, "phase8 vits")

    # (b) the ResNet-50 leg: LARS, T=1, crop-min 0.2, B=256
    r50 = get_preset("imagenet-moco-v3-r50").replace(
        dataset="synthetic", batch_size=V3_R50_BATCH, staging_workers=4, prefetch_depth=2,
        print_freq=1)
    r = _v3_train(r50, "phase8 r50", counters, dataset, V3_R50_STEPS, V3_R50_PER_STEP)
    out["r50"] = dict(imgs_per_s=r["imgs_per_s"], max_memory_gib=r["max_memory_gib"],
                      losses=r["losses"], blur=r["blur"], per_step={
                          k: v / V3_R50_STEPS for k, v in r["launches"].items() if v})
    print(f"phase8 r50: ResNet-50 LARS bf16 batch {V3_R50_BATCH}, {r['imgs_per_s']:.1f} imgs/s "
          f"over steps 2-{V3_R50_STEPS}, peak memory {r['max_memory_gib']:.2f} GiB, launches a "
          f"step {out['r50']['per_step']} ({smi})", flush=True)
    del r

    # (c) one v3 ViT-S step at batch 16, f32: card (the blur kernel) vs CPU
    # (its plain version), from the same weights and the same draws
    cfg = get_preset("imagenet-moco-v3-vits").replace(compute_dtype="float32",
                                                      batch_size=V3_CPU_BATCH)
    rng = np.random.RandomState(0)
    u8 = torch.from_numpy(rng.randint(0, 256, (V3_CPU_BATCH, 224, 224, 3), dtype=np.uint8))
    gen = torch.Generator().manual_seed(3)
    ext = torch.full((V3_CPU_BATCH,), 224.0)
    pair = v3_aug_configs(224)
    draws = [sample_view(ext, ext, c, gen) for c in pair]

    def on(p, dev, **changed):
        return type(p)(**{k: None if v is None else v.to(dev)
                          for k, v in {**vars(p), **changed}.items()})

    def identity(taps):
        one = torch.zeros_like(taps)
        one[:, taps.shape[1] // 2] = 1.0
        return one

    res, views, unblurred = {}, {}, {}
    for dev in ("cpu", "cuda"):
        before = counters["gaussian_blur_batch"].launches
        views[dev] = [apply_view(u8.to(dev), on(p, dev), c) for p, c in zip(draws, pair)]
        if dev == "cuda" and counters["gaussian_blur_batch"].launches != before + 2:
            fail("phase8 check: the card's views did not launch the blur twice", 1)
        # the same draws with identity taps: crop, jitter, solarize and
        # normalize alone, to show where the devices' difference arises
        unblurred[dev] = [apply_view(u8.to(dev), on(p, dev, blur_taps=identity(p.blur_taps)), c)
                          for p, c in zip(draws, pair)]
    for i in range(2):
        ref = views["cpu"][i]
        err = float((views["cuda"][i].cpu() - ref).abs().max() / ref.abs().max())
        if err > V3_VIEW_RTOL:
            fail(f"phase8 check: card and CPU disagree on view {i + 1}: {err:.3e} of its "
                 "largest entry", 1)
        out[f"view{i + 1}_err"] = err
        out[f"view{i + 1}_unblurred_err"] = float(
            (unblurred["cuda"][i].cpu() - unblurred["cpu"][i]).abs().max() / ref.abs().max())
    # the control: view 1 on the CPU with each sample blurred by the next
    # sample's taps, which the tolerance must tell from the card's view
    wrong = type(draws[0])(**{**vars(draws[0]), "blur_taps": draws[0].blur_taps.roll(1, 0)})
    ref = views["cpu"][0]
    control = float((views["cuda"][0].cpu() - apply_view(u8, wrong, pair[0])).abs().max()
                    / ref.abs().max())
    if control <= 10 * V3_VIEW_RTOL:
        fail(f"phase8 check: a wrong blur is {control:.3e} of the largest entry from the "
             f"card's view 1, not beyond 10x the tolerance {V3_VIEW_RTOL:.0e}", 1)
    out["view_control_err"] = control
    for dev in ("cpu", "cuda"):
        # the same (CPU) views into both steps: the step's own agreement
        x1, x2 = (v.to(dev) for v in views["cpu"])
        state = create_train_state(cfg, build_encoder(cfg), dev, seed=0)
        metrics = build_train_step(cfg, steps_per_epoch=8)(state, x1, x2)
        with torch.no_grad():
            keys = torch.nn.functional.normalize(state.model_k(x1), dim=1)
        grads = {part: torch.stack([p.grad.norm() for p in
                                    getattr(state.model_q, part).parameters()
                                    if p.grad is not None]).norm().reshape(1)
                 for part in ("backbone", "projector", "predictor")}
        res[dev] = {k: v.detach().cpu() for k, v in dict(
            loss=metrics["loss"].reshape(1), keys=keys,
            **{f"grad_norm:{k}": v for k, v in grads.items()}).items()}
    worst = (0.0, "")
    for key, ref in res["cpu"].items():
        err = float((res["cuda"][key] - ref).abs().max() / ref.abs().max().clamp(min=1e-12))
        if err > (V3_GRAD_RTOL if key.startswith("grad_norm") else V3_CPU_RTOL):
            fail(f"phase8 check: card and CPU disagree on {key}: {err:.3e} of its largest "
                 "entry", 1)
        worst = max(worst, (err, key))
    print(f"phase8 check: the v3 view pair at 224 px f32 batch {V3_CPU_BATCH} from the same "
          f"draws, card (blur kernel) vs cpu, {out['view1_err']:.3e} / {out['view2_err']:.3e} "
          f"of the largest entry (tolerance {V3_VIEW_RTOL:.0e}; with identity taps "
          f"{out['view1_unblurred_err']:.3e} / {out['view2_unblurred_err']:.3e}; view 1 with "
          f"the next sample's taps, the control: {control:.3e}); a v3 ViT-S/16 step on the same views and weights over "
          f"{len(res['cpu'])} tensors, worst {worst[0]:.3e} ({worst[1]}); loss "
          f"{float(res['cuda']['loss'][0]):.6f} vs {float(res['cpu']['loss'][0]):.6f}",
          flush=True)
    out["check_worst"] = worst[0]
    del res, views

    # (d) the timm export of (a), reloaded bit for bit, and the v3 probe on it
    with tempfile.TemporaryDirectory(prefix="moco_v3_") as tmp:
        path = str(Path(tmp) / "vits_timm.npz")
        flat = ckpt.export_v3_backbone(vits_state, path)
        model = ckpt.load_for_inference(path, "vit_small", device="cuda")
        want = vits_state.model_q.backbone.state_dict()
        got = model.state_dict()
        bad = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        if bad or want.keys() != got.keys():
            fail(f"phase8 export: the reloaded backbone differs at {bad[:5]}", 1)
        probe = get_preset("imagenet-lincls-v3").replace(
            pretrained=path, dataset="synthetic", batch_size=V3_R50_BATCH, epochs=1,
            print_freq=1)
        losses = []
        fc, best = lincls.train_lincls(
            probe, max_steps=V3_PROBE_STEPS, device="cuda",
            dataset=_Repeat(dataset, V3_R50_BATCH * V3_PROBE_STEPS),
            val_dataset=_Head(dataset, V3_R50_BATCH),
            on_step=lambda step, m: losses.append(m["loss"]))
        if len(losses) != V3_PROBE_STEPS or not all(math.isfinite(v) for v in losses):
            fail(f"phase8 probe: losses {losses}", 1)
        print(f"phase8 export: {len(flat)} timm entries, {Path(path).stat().st_size} bytes, "
              f"reloaded by load_for_inference('vit_small') equal bit for bit over "
              f"{len(want)} tensors; imagenet-lincls-v3 probe {V3_PROBE_STEPS} steps (batch "
              f"{V3_R50_BATCH}, 1000 classes) losses {[round(v, 4) for v in losses]}, val "
              f"acc@1 {best:.2f}", flush=True)
    del vits_state

    # (e) the v3 step in a one-rank NCCL group = no group, bit for bit
    group_cfg = get_preset("imagenet-moco-v3-vits").replace(
        dataset="synthetic", batch_size=V3_GROUP_BATCH, staging_workers=4, prefetch_depth=2,
        print_freq=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        calls = dict.fromkeys(NCCL_CALLS, 0)
        alone = _v3_train(group_cfg, "phase8 no group", counters, dataset, V3_GROUP_STEPS,
                          V3_VIT_PER_STEP)
        with tempfile.TemporaryDirectory(prefix="moco_nccl_") as tmp:
            init_distributed("cuda", rank=0, world_size=1,
                             init_method=f"file://{Path(tmp) / 'store'}")
            try:
                grouped = _v3_train(group_cfg, "phase8 one-rank NCCL group", counters, dataset,
                                    V3_GROUP_STEPS, V3_VIT_PER_STEP, calls)
            finally:
                shutdown_distributed()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want_calls = {**dict.fromkeys(NCCL_CALLS, 0), "all_gather": 2 * V3_GROUP_STEPS,
                  "all_reduce": 3 * V3_GROUP_STEPS}
    if calls != want_calls:
        fail(f"phase8 group: NCCL calls {calls}, expected {want_calls} (both views' keys "
             "gathered; gradients, BN statistics and metrics all-reduced)", 1)
    diff = _v3_states_differ(grouped["state"], alone["state"])
    if grouped["losses"] != alone["losses"]:
        diff.append(f"losses {grouped['losses']} != {alone['losses']}")
    if diff:
        fail(f"phase8 group: one-rank group and no group differ in {diff[:6]}", 1)
    print(f"phase8 group: v3 ViT-S batch {V3_GROUP_BATCH}, {V3_GROUP_STEPS} steps, one-rank NCCL "
          f"group = no group bit for bit (losses, both models, AdamW moments, generators); "
          f"NCCL calls a step { {k: v / V3_GROUP_STEPS for k, v in calls.items() if v} }; "
          f"{grouped['imgs_per_s']:.1f} vs {alone['imgs_per_s']:.1f} imgs/s", flush=True)
    return out


PHASE9_STEPS = 10           # (a) and (d): fences (stride 2) on the even steps; the
                            # timed window is steps 2-9, on 12 batches an epoch
PHASE9_CAPTURE_STEPS = 4    # (b): a capture window of 2 steps inside a 4-step run
PHASE9_V3_BATCH = 128       # (c): ViT-S/16, cut from 512 for time
PHASE9_V3_STEPS = 4
# (a)'s telemetry: records flushed every 2, fenced and sampled every 2 steps,
# the health diagnostics every 2 (on state.step 0, 2, 4: records 1, 3, 5)
PHASE9_TELEMETRY = dict(telemetry_stride=2, health_stride=2, telemetry_flush_steps=2,
                        trace_mode="full", resilience_sync_steps=2)
HBM_PEAK_RTOL = 0.01        # run_end's hbm_peak_bytes against max_memory_allocated
H100_SXM = "NVIDIA H100 80GB HBM3"


def _telemetry_train(config, label: str, counters: dict, dataset, steps: int,
                     per_step: dict = PER_STEP) -> dict:
    """`train.train` for `steps` steps with every step's loss and logits kept
    (cloned where the step computes them, no host read), each kernel's
    launches held to its count a step, and the steady rate over steps 2 to
    `steps - 1` on a synchronized clock: the card is drained after step 1
    and before the last step (so the last step's fence still measures its
    own device time). Metrics reach the host on the first step only
    (`print_freq`), so the other steps run asynchronously, as a long run's
    do."""
    import torch

    from moco_tpu_torch import train, train_step

    losses, logits, clock = [], [], {}
    real_build, real_logits = train.build_train_step, train_step.infonce_logits

    def capture(*args, **kw):
        out = real_logits(*args, **kw)
        logits.append(out[0].detach().clone())
        return out

    def build(cfg, steps_per_epoch, group=None):
        step = real_build(cfg, steps_per_epoch, group=group)

        def run(state, im_q, im_k):
            if state.step == steps - 1:
                torch.cuda.synchronize()
                clock["end"] = time.perf_counter()
            metrics = step(state, im_q, im_k)
            losses.append(metrics["loss"].detach().clone())
            if state.step == 1:
                torch.cuda.synchronize()
                clock["start"] = time.perf_counter()
            return metrics
        return run

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train.build_train_step, train_step.infonce_logits = build, capture
    try:
        state, _ = train.train(config, max_steps=steps, device="cuda", dataset=dataset,
                               on_step=lambda *a: None)
    finally:
        train.build_train_step, train_step.infonce_logits = real_build, real_logits
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name in counters:
        if launches[name] != per_step.get(name, 0) * steps:
            fail(f"{label}: {name} launched {launches[name]} times in {steps} steps, expected "
                 f"{per_step.get(name, 0) * steps}", 1)
    values = [float(v) for v in losses]
    if len(values) != steps or not all(math.isfinite(v) for v in values):
        fail(f"{label}: non-finite or missing losses {values}", 1)
    return dict(state=state, losses=values, logits=logits, launches=launches,
                max_memory=torch.cuda.max_memory_allocated(),
                imgs_per_s=config.batch_size * (steps - 2) / (clock["end"] - clock["start"]))


def _read_events(tel_dir: Path) -> list[dict]:
    with open(tel_dir / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def _check_events(records: list[dict], label: str, steps: int, stride: int,
                  health_stride: int, kind: str, peak) -> list[dict]:
    """The JAX package's records of a `steps`-step run: one run_start with the
    card's name and peak, step records 1..steps with device_s on the fenced
    steps, MFU in (0, 1) on every step, a finite health block on the
    health-stride steps, one run_end. Returns the step records."""
    starts = [r for r in records if r["kind"] == "run_start"]
    ends = [r for r in records if r["kind"] == "run_end"]
    steps_rec = [r for r in records if r["kind"] == "step"]
    if len(starts) != 1 or len(ends) != 1:
        fail(f"{label}: {len(starts)} run_start and {len(ends)} run_end records", 1)
    if starts[0]["device_kind"] != kind or starts[0]["peak_flops_per_chip"] != peak:
        fail(f"{label}: run_start names {starts[0]['device_kind']!r} at "
             f"{starts[0]['peak_flops_per_chip']}, expected {kind!r} at {peak}", 1)
    if [r["step"] for r in steps_rec] != list(range(1, steps + 1)):
        fail(f"{label}: step records {[r['step'] for r in steps_rec]}", 1)
    fenced = [r["step"] for r in steps_rec if "device_s" in r]
    if fenced != list(range(stride, steps + 1, stride)):
        fail(f"{label}: device_s on steps {fenced}, expected every {stride}th", 1)
    if not all(0.0 < r.get("mfu", 0.0) < 1.0 for r in steps_rec):
        fail(f"{label}: mfu {[r.get('mfu') for r in steps_rec]} not in (0, 1) on every step", 1)
    with_health = [r["step"] for r in steps_rec if "health" in r]
    if with_health != list(range(1, steps + 1, health_stride)):
        fail(f"{label}: health blocks on steps {with_health}", 1)
    for r in steps_rec:
        if "health" in r and not all(isinstance(v, float) and math.isfinite(v)
                                     for v in r["health"].values()):
            fail(f"{label}: step {r['step']} health block {r['health']} is not finite", 1)
    return steps_rec


def _phase_split(steps_rec: list[dict]) -> dict:
    """Mean seconds of each phase over steps 2.., the fenced ones for
    device_s / comm_s; mean MFU over steps 2.."""
    steady = steps_rec[1:]
    out = {}
    for key in ("step_s", "data_s", "host_s", "telemetry_s", "device_s", "comm_s", "mfu"):
        vals = [r[key] for r in steady if key in r]
        if vals:
            out[key] = sum(vals) / len(vals)
    return out


def run_telemetry(counters: dict, dataset, smi: str) -> dict:
    """Phase 9: the run telemetry and learning health on the card (see the
    module docstring)."""
    import tempfile

    import torch

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed
    from moco_tpu_torch.telemetry.mfu import detect_peak_flops, train_step_flops

    kind = torch.cuda.get_device_name(0)
    peak = detect_peak_flops(kind)
    if peak is None or (kind == H100_SXM and peak != 989.4e12):
        fail(f"phase9: no datasheet peak for {kind!r} ({peak})", 1)
    base = get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", batch_size=BATCH, staging_workers=4, prefetch_depth=2,
        print_freq=1000)
    # 12 batches an epoch (phase 3's 6, twice): no epoch boundary in a run
    dataset = _Repeat(dataset, 2 * len(dataset))
    out = {"device_kind": kind, "peak_flops_per_chip": peak}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="moco_phase9_") as tmp:
            tmp = Path(tmp)
            # (a) the v2 step with telemetry and health on, and with both off;
            # telemetry alone (health off) splits the fence's cost from the
            # health pull's. In the order off, on, telemetry alone, off.
            on_cfg = base.replace(telemetry_dir=str(tmp / "a"), **PHASE9_TELEMETRY)
            off = _telemetry_train(base, "phase9 telemetry off", counters, dataset,
                                   PHASE9_STEPS)
            on = _telemetry_train(on_cfg, "phase9 telemetry on", counters, dataset,
                                  PHASE9_STEPS)
            tel_cfg = on_cfg.replace(telemetry_dir=str(tmp / "a_tel"), health_stride=0,
                                     trace_mode="steps")
            tel = _telemetry_train(tel_cfg, "phase9 telemetry alone", counters, dataset,
                                   PHASE9_STEPS)
            off2 = _telemetry_train(base, "phase9 telemetry off, again", counters, dataset,
                                    PHASE9_STEPS)
            compare_runs(on, off, "phase9 telemetry and health on vs off", PHASE9_STEPS)
            compare_runs(tel, off2, "phase9 telemetry alone vs off", PHASE9_STEPS)
            if not on["launches"] == off["launches"] == tel["launches"]:
                fail(f"phase9: launches {on['launches']} with telemetry, {off['launches']} "
                     "without", 1)
            tel_fenced = [r["step"] for r in _read_events(tmp / "a_tel")
                          if r["kind"] == "step" and "device_s" in r]
            if tel_fenced != list(range(2, PHASE9_STEPS + 1, 2)):
                fail(f"phase9 (a): telemetry alone fenced steps {tel_fenced}", 1)
            records = _read_events(tmp / "a")
            steps_rec = _check_events(records, "phase9 (a)", PHASE9_STEPS, 2, 2, kind, peak)
            tel_split = _phase_split([r for r in _read_events(tmp / "a_tel")
                                      if r["kind"] == "step"])
            (end,) = [r for r in records if r["kind"] == "run_end"]
            if abs(end["hbm_peak_bytes"] - on["max_memory"]) > HBM_PEAK_RTOL * on["max_memory"]:
                fail(f"phase9: hbm_peak_bytes {end['hbm_peak_bytes']} against "
                     f"max_memory_allocated {on['max_memory']}", 1)
            if any("comm_s" in r for r in steps_rec) or any(r["kind"] == "pod"
                                                             for r in records):
                fail("phase9 (a): comm_s or a pod record with no process group", 1)
            with open(tmp / "a" / "heartbeat.json") as f:
                beat = json.load(f)
            with open(tmp / "a" / "spans.jsonl") as f:
                spans = [json.loads(line) for line in f]
            names = {s["name"] for s in spans}
            if beat["phase"] != "run_end" or not {"stage_batch", "decode_slice", "h2d_shard",
                                                  "step"} <= names:
                fail(f"phase9 (a): heartbeat {beat}, spans {sorted(names)}", 1)
            split = _phase_split(steps_rec)
            health = [r["health"] for r in steps_rec if "health" in r]
            out["a"] = dict(imgs_per_s_on=on["imgs_per_s"], imgs_per_s_off=off["imgs_per_s"],
                            imgs_per_s_telemetry_alone=tel["imgs_per_s"],
                            imgs_per_s_off_again=off2["imgs_per_s"], split=split,
                            split_telemetry_alone=tel_split,
                            hbm_peak_bytes=end["hbm_peak_bytes"],
                            max_memory=on["max_memory"], health=health[-1],
                            mfu_timed=train_step_flops(on_cfg) * on["imgs_per_s"] / BATCH / peak)
            print(f"phase9 (a) ({smi}): imagenet-moco-v2 B={BATCH}, {PHASE9_STEPS} steps, "
                  f"metrics on the host at step 1 only; imgs/s over steps 2-{PHASE9_STEPS - 1} "
                  f"(synchronized clock), in run order: off {off['imgs_per_s']:.1f}, telemetry "
                  f"+ health (stride 2) {on['imgs_per_s']:.1f}, telemetry alone (fence at "
                  f"stride 2, spans at steps) {tel['imgs_per_s']:.1f}, off "
                  f"{off2['imgs_per_s']:.1f}; telemetry alone, phases (mean s, steps 2-"
                  f"{PHASE9_STEPS}): " + ", ".join(f"{k} {v:.6f}" for k, v in tel_split.items())
                  + f"; telemetry + health: MFU {split['mfu']:.4f} over the "
                  f"records of steps 2-{PHASE9_STEPS}, {out['a']['mfu_timed']:.4f} from the "
                  f"timed rate (peak {peak:.4g} FLOP/s); phases (mean s, steps 2-"
                  f"{PHASE9_STEPS}): " + ", ".join(f"{k} {v:.6f}" for k, v in split.items()
                                                   if k != "mfu")
                  + f"; hbm_peak_bytes {end['hbm_peak_bytes']} vs max_memory_allocated "
                  f"{on['max_memory']}; spans {len(spans)} ({sorted(names)}); health at step "
                  f"{steps_rec[-2]['step']}: {health[-1]}", flush=True)

            # (b) a capture window from the trigger file, with a device profile
            cap_dir = tmp / "b"
            cap_dir.mkdir()
            (cap_dir / "trace.trigger").write_text("")
            cap_cfg = base.replace(telemetry_dir=str(cap_dir), telemetry_stride=2,
                                   trace_device_profile=True, trace_capture_steps=2)
            _telemetry_train(cap_cfg, "phase9 capture", counters, dataset,
                             PHASE9_CAPTURE_STEPS)
            actions = [r["action"] for r in _read_events(cap_dir)
                       if r.get("event") == "trace_capture"]
            traces = sorted((cap_dir / "traces").rglob("trace_*.json"))
            text = traces[0].read_text() if len(traces) == 1 else ""
            missing = [k for k in ("channel_sums_rows", "blur_rows") if k not in text]
            if actions != ["start", "end"] or len(traces) != 1 or missing:
                fail(f"phase9 (b): capture events {actions}, traces {traces}, kernels "
                     f"missing from the trace {missing}", 1)
            out["b"] = dict(trace_bytes=len(text), kernels=["channel_sums_rows", "blur_rows"])
            print(f"phase9 (b): trace.trigger armed a capture window (events {actions}); "
                  f"torch.profiler trace {traces[0].relative_to(cap_dir)} ({len(text)} bytes) "
                  "names channel_sums_rows and blur_rows", flush=True)

            # (d) (a)'s telemetry run in a one-rank NCCL group
            grp_cfg = on_cfg.replace(telemetry_dir=str(tmp / "d"))
            init_distributed("cuda", rank=0, world_size=1,
                             init_method=f"file://{tmp / 'store'}")
            try:
                grouped = _telemetry_train(grp_cfg, "phase9 one-rank NCCL group", counters,
                                           dataset, PHASE9_STEPS)
            finally:
                shutdown_distributed()
            compare_runs(grouped, on, "phase9 one-rank NCCL group vs no group, telemetry on",
                         PHASE9_STEPS)
            evens = list(range(2, PHASE9_STEPS + 1, 2))
            records = _read_events(tmp / "d")
            steps_rec = _check_events(records, "phase9 (d)", PHASE9_STEPS, 2, 2, kind, peak)
            comm = [r["step"] for r in steps_rec if "comm_s" in r]
            pods = [r for r in records if r["kind"] == "pod"]
            if comm != evens or [p["step"] for p in pods] != evens or any(
                    p["hosts"] != 1 for p in pods):
                fail(f"phase9 (d): comm_s on steps {comm}, pod records "
                     f"{[(p['step'], p['hosts']) for p in pods]}", 1)
            gsplit = _phase_split(steps_rec)
            out["d"] = dict(imgs_per_s=grouped["imgs_per_s"], split=gsplit, pod=pods[-1])
            print(f"phase9 (d): one-rank NCCL group, {grouped['imgs_per_s']:.1f} imgs/s; comm_s "
                  f"(device time, fused all-reduce) {[r['comm_s'] for r in steps_rec if 'comm_s' in r]}"
                  f" s on steps {comm}; pod records at {[p['step'] for p in pods]}: {pods[-1]}",
                  flush=True)
            del on, off, tel, off2, grouped

            # (c) the v3 leg: ViT-S/16 at B=128 with health every 2 steps
            v3_cfg = get_preset("imagenet-moco-v3-vits").replace(
                dataset="synthetic", batch_size=PHASE9_V3_BATCH, staging_workers=4,
                prefetch_depth=2, print_freq=1, telemetry_dir=str(tmp / "c"),
                telemetry_stride=2, health_stride=2, telemetry_flush_steps=2)
            r = _v3_train(v3_cfg, "phase9 (c) vits", counters, dataset, PHASE9_V3_STEPS,
                          V3_VIT_PER_STEP)
            steps_rec = _check_events(_read_events(tmp / "c"), "phase9 (c)", PHASE9_V3_STEPS,
                                      2, 2, kind, peak)
            blocks = [rec["health"] for rec in steps_rec if "health" in rec]
            if not all("pdrift" in b and not any(k.startswith("q") for k in b)
                       for b in blocks):
                fail(f"phase9 (c): v3 health blocks {blocks}", 1)
            vsplit = _phase_split(steps_rec)
            out["c"] = dict(imgs_per_s=r["imgs_per_s"], split=vsplit, health=blocks[-1],
                            blur=r["blur"])
            print(f"phase9 (c): imagenet-moco-v3-vits B={PHASE9_V3_BATCH}, {r['imgs_per_s']:.1f} "
                  f"imgs/s (metrics on the host every step), MFU {vsplit['mfu']:.4f} over steps "
                  f"2-{PHASE9_V3_STEPS}; health {blocks[-1]}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


PHASE10_STEPS = 10          # (a): the sentinel off, on, on, off; timed over steps 2-9
PHASE10_ROLLBACK = dict(steps_per_epoch=2, epochs=3, max_rollbacks=3)
PHASE10_NAN_AT = 3          # (b): poisons epoch 1's first batch; restored at step 2,
PHASE10_ROLLBACK_END = 5    # the rerun skips that batch: steps 3-5 from batches 1, 0, 1
PHASE10_PREEMPT_STEPS = 5   # (c): uninterrupted run, and SIGTERM after step 3
PHASE10_SIGTERM_AT = 3
PHASE10_WATCHDOG_S = 2.0    # (e): the watchdog's interval (polled every 0.5 s), under
PHASE10_SLOW_MS = 3300      # the slow step's sleep: one flag by 2.5 s, a second needs 4 s
PHASE10_KNN_SLEEP_S = 3.0   # (e): added to each kNN monitor run inside the loop


def _kept_train(config, label: str, counters: dict, dataset, max_steps, run=None) -> dict:
    """`train.train` (or `run(config)` for another entry) with every executed
    step's loss (a device copy) and logits kept, each kernel's launches held
    to its count a step over the steps executed (a rollback executes some
    twice). Returns the state, history, losses, logits, executed steps and
    launches."""
    import torch

    from moco_tpu_torch import train, train_step

    losses, logits = [], []
    real_build, real_logits = train.build_train_step, train_step.infonce_logits

    def capture(*args, **kw):
        out = real_logits(*args, **kw)
        logits.append(out[0].detach().clone())
        return out

    def build(cfg, steps_per_epoch, group=None):
        step = real_build(cfg, steps_per_epoch, group=group)

        def one(state, im_q, im_k):
            metrics = step(state, im_q, im_k)
            losses.append(metrics["loss"].detach().clone())
            return metrics
        return one

    for fn in counters.values():
        fn.launches = 0
    train.build_train_step, train_step.infonce_logits = build, capture
    try:
        if run is None:
            state, history = train.train(config, max_steps=max_steps, device="cuda",
                                         dataset=dataset, on_step=lambda *a: None)
        else:
            state, history = run(config)
    finally:
        train.build_train_step, train_step.infonce_logits = real_build, real_logits
    torch.cuda.synchronize()
    executed = len(losses)
    launches = {name: fn.launches for name, fn in counters.items()}
    for name in counters:
        if launches[name] != PER_STEP.get(name, 0) * executed:
            fail(f"{label}: {name} launched {launches[name]} times in {executed} steps, "
                 f"expected {PER_STEP.get(name, 0) * executed}", 1)
    return dict(state=state, history=history, losses=[float(v) for v in losses],
                logits=logits, executed=executed, launches=launches)


def _same_steps(a: dict, b: dict, label: str, a_slice: slice, b_slice: slice,
                states: bool = True) -> None:
    """Fail unless the kept losses and logits of two runs' step ranges (and,
    with `states`, their final states) are equal bit for bit."""
    import torch

    diff = _states_equal(a["state"], b["state"]) if states else []
    la, lb = a["losses"][a_slice], b["losses"][b_slice]
    if la != lb:
        diff.append(f"losses {la} != {lb}")
    ga, gb = a["logits"][a_slice], b["logits"][b_slice]
    if len(ga) != len(gb) or not all(torch.equal(x, y) for x, y in zip(ga, gb)):
        diff.append("logits")
    if diff:
        fail(f"{label}: the runs differ in {diff[:6]} (deterministic cuDNN was on)", 1)


def run_resilience(counters: dict, dataset, smi: str) -> dict:
    """Phase 10: the resilience of the driver on the card (see the module
    docstring). (d) runs right after (a) on its state, so that its first
    asynchronous save is the process's first (cold pinned memory)."""
    import tempfile

    import numpy as np
    import torch

    from moco_tpu_torch import checkpoint as ckpt
    from moco_tpu_torch import train
    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.resilience import ChaosPlan, NaNSentinel, StepWatchdog, chaos_context
    from moco_tpu_torch.resilience.integrity import manifest_path, verify_step
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder
    from moco_tpu_torch.utils import logging as mlog

    base = get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", batch_size=BATCH, staging_workers=4, prefetch_depth=2,
        print_freq=1000)
    # 12 batches an epoch (phase 3's 6, twice)
    dataset = _Repeat(dataset, 2 * len(dataset))
    events = []

    def sink(kind, msg, fields):
        events.append((time.perf_counter(), kind, msg))

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    real_sentinel, real_watchdog, real_knn = train.NaNSentinel, train.StepWatchdog, \
        train.knn_monitor
    made = []

    class KeptSentinel(NaNSentinel):
        def __init__(self):
            super().__init__()
            made.append(self)

    class KeptWatchdog(StepWatchdog):
        def __init__(self, interval):
            super().__init__(interval)
            made.append(self)

    mlog.add_event_sink(sink)
    train.NaNSentinel, train.StepWatchdog = KeptSentinel, KeptWatchdog
    try:
        with tempfile.TemporaryDirectory(prefix="moco_phase10_") as tmp:
            tmp = Path(tmp)
            # (a) the sentinel off, on, on, off
            off_cfg = base.replace(loss_sentinel=False)
            runs = []
            for label, cfg in (("off", off_cfg), ("on", base), ("on, again", base),
                               ("off, again", off_cfg)):
                made.clear()
                r = _telemetry_train(cfg, f"phase10 (a) sentinel {label}", counters, dataset,
                                     PHASE10_STEPS)
                sentinels = [m for m in made if isinstance(m, NaNSentinel)]
                if (len(sentinels) == 1) != cfg.loss_sentinel:
                    fail(f"phase10 (a): {len(sentinels)} sentinels with loss_sentinel "
                         f"{cfg.loss_sentinel}", 1)
                if sentinels and sentinels[0].checks != PHASE10_STEPS:
                    fail(f"phase10 (a): the sentinel checked {sentinels[0].checks} of "
                         f"{PHASE10_STEPS} losses", 1)
                r["blocked"] = sentinels[0].blocked if sentinels else None
                runs.append(r)
            off, on, on2, off2 = runs
            compare_runs(on, off, "phase10 (a) sentinel on vs off", PHASE10_STEPS)
            compare_runs(on2, off2, "phase10 (a) sentinel on vs off, again", PHASE10_STEPS)
            out["a"] = dict(imgs_per_s_off=off["imgs_per_s"], imgs_per_s_on=on["imgs_per_s"],
                            imgs_per_s_on_again=on2["imgs_per_s"],
                            imgs_per_s_off_again=off2["imgs_per_s"],
                            blocked=[on["blocked"], on2["blocked"]], checks=PHASE10_STEPS)
            print(f"phase10 (a) ({smi}): imagenet-moco-v2 B={BATCH}, {PHASE10_STEPS} steps, "
                  f"imgs/s over steps 2-{PHASE10_STEPS - 1} (synchronized clock), in run "
                  f"order: sentinel off {off['imgs_per_s']:.1f}, on {on['imgs_per_s']:.1f}, on "
                  f"{on2['imgs_per_s']:.1f}, off {off2['imgs_per_s']:.1f}; checks that waited "
                  f"for their copy {on['blocked']} and {on2['blocked']} of {PHASE10_STEPS}; "
                  "losses, logits, enqueued keys and state equal bit for bit; launches "
                  f"{on['launches']}", flush=True)
            state = off2["state"]
            del off, on, on2, runs

            # (d) the asynchronous save against the synchronous one, on (a)'s state
            images, _, extents = (torch.from_numpy(a).to("cuda")
                                  for a in dataset.get_batch(np.arange(BATCH)))
            step0 = state.step
            sync_mgr = ckpt.checkpoint_manager(str(tmp / "d_sync"))
            async_mgr = ckpt.checkpoint_manager(str(tmp / "d_async"))
            _, sync_s = _cuda_time(lambda: ckpt.save_checkpoint(sync_mgr, state, step0,
                                                                position=(0, step0)))
            holds, after_s, finalize_s = [], [], []
            for n in range(2):
                if n == 1:  # a step alone, against which the second save's step is read
                    _, plain_step_s = _cuda_time(
                        lambda: _step_logits(base, state, images, extents))
                step = state.step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save_checkpoint(async_mgr, state, step, position=(0, step), wait=False)
                holds.append(time.perf_counter() - t0)
                if os.path.exists(manifest_path(async_mgr.directory, step)):
                    fail("phase10 (d): the manifest exists before finalize_checkpoints", 1)
                # the next step updates the state in place right behind the copies
                _step_logits(base, state, images, extents)
                torch.cuda.synchronize()
                after_s.append(time.perf_counter() - t0)
                _, s = _cuda_time(lambda: ckpt.finalize_checkpoints(async_mgr))
                finalize_s.append(s)
                if verify_step(async_mgr.directory, step) is not None or not os.path.exists(
                        manifest_path(async_mgr.directory, step)):
                    fail(f"phase10 (d): step {step}'s manifest after finalize: "
                         f"{verify_step(async_mgr.directory, step)}", 1)
                if n == 0:
                    # the state the first async save restores to is the synchronous one
                    a = create_train_state(base, build_encoder(base), "cuda", seed=1)
                    b = create_train_state(base, build_encoder(base), "cuda", seed=2)
                    ckpt.restore_checkpoint(sync_mgr, a, step0)
                    ckpt.restore_checkpoint(async_mgr, b, step0)
                    diff = _states_equal(a, b)
                    if diff or not _states_equal(b, state):
                        fail(f"phase10 (d): the async-saved step restores differently from "
                             f"the synchronous save ({diff[:5]}), or equals the stepped "
                             "state", 1)
                    del a, b
            nbytes = os.path.getsize(os.path.join(sync_mgr.step_dir(step0), ckpt.STATE_FILE))
            out["d"] = dict(sync_save_s=sync_s, async_hold_s=holds, plain_step_s=plain_step_s,
                            step_after_save_s=after_s, finalize_s=finalize_s, bytes=nbytes)
            print(f"phase10 (d): {nbytes} bytes; synchronous save {sync_s:.4f} s; "
                  f"asynchronous save returns in {holds[0]:.4f} s (first, cold pinned "
                  f"memory) and {holds[1]:.4f} s (second); save + the next step "
                  f"{after_s[0]:.4f} / {after_s[1]:.4f} s against {plain_step_s:.4f} s for a "
                  f"step alone (synchronized clock); finalize waited {finalize_s[0]:.4f} / "
                  f"{finalize_s[1]:.4f} s; the manifest appeared at finalize; the async-saved "
                  "step restores equal to the synchronous save bit for bit", flush=True)
            del state
            torch.cuda.empty_cache()

            # (b) a rollback: NaN injected at step 3, restored from the epoch-1 save
            rb_cfg = base.replace(ckpt_dir=str(tmp / "b"), telemetry_dir=str(tmp / "b_tel"),
                                  **PHASE10_ROLLBACK)
            events.clear()
            t0 = time.perf_counter()
            with chaos_context(ChaosPlan(nan_at_step=PHASE10_NAN_AT)):
                rb = _kept_train(rb_cfg, "phase10 (b) rollback", counters, dataset, None)
            rb_s = time.perf_counter() - t0
            kinds = [k for _, k, _ in events]
            t_detect = next(t for t, k, _ in events if k == "sentinel")
            t_restored = next(t for t, k, m in events if k == "rollback" and "advancing" in m)
            if rb["state"].step != PHASE10_ROLLBACK_END or rb["executed"] != 7 \
                    or kinds.count("rollback") != 2 or "sentinel" not in kinds:
                fail(f"phase10 (b): final step {rb['state'].step} after {rb['executed']} "
                     f"executed steps, events {kinds}", 1)
            tel_kinds = [r.get("event") for r in _read_events(tmp / "b_tel")
                         if r["kind"] == "event"]
            if "sentinel" not in tel_kinds or "rollback" not in tel_kinds:
                fail(f"phase10 (b): events.jsonl holds {tel_kinds}", 1)
            if ckpt.checkpoint_manager(rb_cfg.ckpt_dir).all_steps() != [2, 3, 5]:
                fail(f"phase10 (b): kept steps "
                     f"{ckpt.checkpoint_manager(rb_cfg.ckpt_dir).all_steps()}", 1)
            # the same pass by hand: resumed from the restored step, the same skip
            ref = _kept_train(
                rb_cfg, "phase10 (b) resumed by hand", counters, dataset, None,
                run=lambda cfg: train._train_once(
                    cfg.replace(ckpt_dir=str(tmp / "b_ref"), telemetry_dir="",
                                resume=str(tmp / "b" / "2")),
                    None, "cuda", dataset, lambda *a: None, None,
                    data_advance=PHASE10_NAN_AT, poison_pos=(1, 0)))
            _same_steps(rb, ref, "phase10 (b) rollback vs the resumed pass",
                        slice(4, None), slice(None))
            out["b"] = dict(final_step=rb["state"].step, executed=rb["executed"],
                            run_s=rb_s, detect_to_restored_s=t_restored - t_detect)
            print(f"phase10 (b): nan_at_step={PHASE10_NAN_AT}, 2 steps an epoch: sentinel at "
                  f"step {PHASE10_NAN_AT}, rollback to step 2, final step {rb['state'].step} "
                  f"after {rb['executed']} executed steps ({rb_s:.2f} s in all); detection to "
                  f"restored state {t_restored - t_detect:.4f} s; steps 3-5 equal a pass "
                  "resumed by hand from step 2 skipping epoch 1's batch 0 bit for bit "
                  "(losses, logits, state)", flush=True)
            del rb, ref
            torch.cuda.empty_cache()

            # (c) SIGTERM mid-epoch, the emergency checkpoint, the resume
            whole = _kept_train(base, "phase10 (c) uninterrupted", counters, dataset,
                                PHASE10_PREEMPT_STEPS)
            pre_cfg = base.replace(ckpt_dir=str(tmp / "c"), telemetry_dir=str(tmp / "c_tel"))
            events.clear()
            with chaos_context(ChaosPlan(sigterm_at_step=PHASE10_SIGTERM_AT)):
                cut = _kept_train(pre_cfg, "phase10 (c) preempted", counters, dataset,
                                  PHASE10_PREEMPT_STEPS)
            with open(tmp / "c_tel" / "heartbeat.json") as f:
                beat = json.load(f)
            mgr = ckpt.checkpoint_manager(pre_cfg.ckpt_dir)
            if cut["state"].step != PHASE10_SIGTERM_AT or cut["history"][-1] != {
                    "step": PHASE10_SIGTERM_AT, "preempted": True} \
                    or mgr.all_steps() != [PHASE10_SIGTERM_AT] \
                    or ckpt.read_position(mgr.directory, PHASE10_SIGTERM_AT) != (
                        0, PHASE10_SIGTERM_AT) \
                    or verify_step(mgr.directory, PHASE10_SIGTERM_AT) is not None \
                    or beat["phase"] != "preempt_exit" \
                    or not any(k == "preempt" and "caught signal" in m for _, k, m in events):
                fail(f"phase10 (c): stopped at {cut['state'].step}, history end "
                     f"{cut['history'][-1]}, steps {mgr.all_steps()}, heartbeat "
                     f"{beat['phase']}, events {[k for _, k, _ in events]}", 1)
            resumed = _kept_train(pre_cfg.replace(resume="auto", telemetry_dir=""),
                                  "phase10 (c) resumed", counters, dataset,
                                  PHASE10_PREEMPT_STEPS)
            _same_steps(cut, whole, "phase10 (c) preempted vs uninterrupted, steps 1-3",
                        slice(None), slice(0, PHASE10_SIGTERM_AT), states=False)
            _same_steps(resumed, whole, "phase10 (c) resumed vs uninterrupted",
                        slice(None), slice(PHASE10_SIGTERM_AT, None))
            out["c"] = dict(stopped=PHASE10_SIGTERM_AT, position=[0, PHASE10_SIGTERM_AT],
                            heartbeat=beat["phase"])
            print(f"phase10 (c): a real SIGTERM after step {PHASE10_SIGTERM_AT} stopped the "
                  f"run there; emergency checkpoint at position (0, {PHASE10_SIGTERM_AT}) "
                  "with its manifest, heartbeat preempt_exit; the resumed run's steps "
                  f"{PHASE10_SIGTERM_AT + 1}-{PHASE10_PREEMPT_STEPS} (losses, logits, "
                  "enqueued keys) and final state equal the uninterrupted run's bit for bit",
                  flush=True)
            del whole, cut, resumed
            torch.cuda.empty_cache()

            # (e) the watchdog: one flag for the slow step, none in the kNN monitor
            def slow_knn(config, feature_fn, state, *args, **kw):
                if state.step:  # the in-loop runs, under watchdog.suspended()
                    time.sleep(PHASE10_KNN_SLEEP_S)
                return real_knn(config, feature_fn, state, *args, **kw)

            wd_cfg = base.replace(steps_per_epoch=2, knn_monitor=True, knn_bank_size=BATCH,
                                  num_classes=10, watchdog_secs=PHASE10_WATCHDOG_S)
            made.clear()
            events.clear()
            train.knn_monitor = slow_knn
            with chaos_context(ChaosPlan(slow_at_step=3, slow_ms=PHASE10_SLOW_MS)):
                wd = _kept_train(wd_cfg, "phase10 (e) watchdog", counters, dataset, 3)
            train.knn_monitor = real_knn
            (dog,) = [m for m in made if isinstance(m, StepWatchdog)]
            flags = [m for _, k, m in events if k == "watchdog"]
            knn_runs = [h for h in wd["history"] if "knn_train_top1" in h]
            if dog.stalls != 1 or len(flags) != 1 or "last completed step 2" not in flags[0] \
                    or [h["step"] for h in knn_runs] != [2, 3]:
                fail(f"phase10 (e): {dog.stalls} stalls, flags {flags}, kNN runs at "
                     f"{[h['step'] for h in knn_runs]}", 1)
            out["e"] = dict(stalls=dog.stalls, flag=flags[0])
            print(f"phase10 (e): watchdog_secs {PHASE10_WATCHDOG_S}, a {PHASE10_SLOW_MS} ms "
                  f"slow step 3: one flag ({flags[0]!r}); none in the two kNN monitor runs "
                  f"(each held {PHASE10_KNN_SLEEP_S} s longer)", flush=True)
            del wd
            torch.cuda.empty_cache()

            # (f) the CLI exits 43 after an injected SIGTERM (cut to 96 px and
            # batch 64: the CLI draws its own 2048 synthetic images)
            cmd = [sys.executable, "-m", "moco_tpu_torch.train", "--preset",
                   "imagenet-moco-v2", "--dataset", "synthetic", "--image-size", "96",
                   "--batch-size", "64", "--steps-per-epoch", "4", "--max-steps", "4",
                   "--print-freq", "1", "--chaos", "sigterm_at_step=2",
                   "--ckpt-dir", str(tmp / "f"), "--telemetry-dir", str(tmp / "f_tel")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            cli_s = time.perf_counter() - t0
            with open(tmp / "f_tel" / "heartbeat.json") as f:
                beat = json.load(f)
            if proc.returncode != 43 or ckpt.checkpoint_manager(
                    str(tmp / "f")).all_steps() != [2] or beat["phase"] != "preempt_exit":
                fail(f"phase10 (f): exit {proc.returncode}, heartbeat {beat}, stderr "
                     f"{proc.stderr[-2000:]}", 1)
            out["f"] = dict(returncode=proc.returncode, seconds=cli_s)
            print(f"phase10 (f): `python -m moco_tpu_torch.train ... --chaos "
                  f"sigterm_at_step=2` exited {proc.returncode} (EXIT_PREEMPTED) in "
                  f"{cli_s:.1f} s with an emergency checkpoint at step 2", flush=True)
    finally:
        mlog.remove_event_sink(sink)
        train.NaNSentinel, train.StepWatchdog, train.knn_monitor = \
            real_sentinel, real_watchdog, real_knn
        torch.backends.cudnn.deterministic = deterministic
    return out


PHASE11_SPE = 2             # (a)-(c): 2 steps an epoch, a checkpoint each
PHASE11_EPOCHS = 3          # 6 steps
PHASE11_STALE_S = 5.0       # (b): the supervisor's staleness window
PHASE11_D_SPE = 8           # (d): 8 steps an epoch, 24 steps over 4, 2, 4 and 4 cards
PHASE11_D_EPOCHS = 3
PHASE11_D_RESIZE_AT = 4     # (d): the chaos request for 2 cards after step 4
PHASE11_D_GROW_AFTER = 9    # (d): the operator's request for 4 once step 9 has run
PHASE11_D_TERM_AFTER = 16   # (d): SIGTERM to one rank once step 16 has run


def _supervised_argv(tmp: Path, spe: int, epochs: int, *extra: str) -> list[str]:
    """`python -m moco_tpu_torch.train` at `imagenet-moco-v2`'s full width on
    its synthetic data, every step's loss in `events.jsonl`, under
    deterministic cuDNN."""
    return [sys.executable, "-m", "moco_tpu_torch.train", "--preset", "imagenet-moco-v2",
            "--dataset", "synthetic", "--steps-per-epoch", str(spe), "--epochs", str(epochs),
            "--print-freq", "1", "--deterministic", "true", "--telemetry-dir",
            str(tmp / "tel"), "--ckpt-dir", str(tmp / "ck"), "--heartbeat-secs", "0",
            "--telemetry-flush-steps", "1", *extra]


def _run_pids_alive(tag: str) -> list[int]:
    """Live processes (zombies count as gone) whose command line holds `tag`."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if tag in cmd and _pid_alive(int(name)):
            out.append(int(name))
    return out


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _supervise(argv: list[str], tmp: Path, env: dict, stale_s: float, watch=None) -> dict:
    """Run `argv` under the port's `Supervisor` (in a thread; `watch(sup)`
    polls beside it until the run ends), then check that no process of the
    run is left. Returns the result, the incidents, the events and the pids."""
    import threading

    from moco_tpu_torch.resilience.supervisor import RestartPolicy, Supervisor, \
        read_events_tail

    sup = Supervisor(argv, telemetry_dir=str(tmp / "tel"), ckpt_dir=str(tmp / "ck"), env=env,
                     policy=RestartPolicy(max_restarts=3, heartbeat_stale_secs=stale_s,
                                          startup_grace_secs=600.0, term_grace_secs=5.0,
                                          backoff_base_secs=0.1, backoff_max_secs=1.0,
                                          backoff_jitter=0.0, poll_secs=0.1), seed=0)
    box = {}
    runner = threading.Thread(target=lambda: box.update(result=sup.run()), daemon=True)
    runner.start()
    while runner.is_alive():
        if watch is not None:
            watch(sup)
        runner.join(timeout=0.05)
    records = read_events_tail(str(tmp / "tel" / "events.jsonl"), max_bytes=1 << 26)
    log = (tmp / "tel" / "child.log").read_text(errors="replace")
    pids = {r["pid"] for r in sup.incidents if r["event"] == "launch"}
    for line in log.splitlines():
        if line.startswith("[launch]") and "pids [" in line:
            pids |= set(json.loads(line[line.index("pids [") + 5:]))
    left = sorted(set(_run_pids_alive(str(tmp))) | {p for p in pids if _pid_alive(p)})
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.split("\n")
    on_card = [a.strip() for a in apps if a.split(",")[0].strip().isdigit()
               and int(a.split(",")[0]) in pids]
    if left or on_card:
        fail(f"processes of the supervised run left: {left}, on the card: {on_card}", 1)
    return dict(result=box.get("result"), incidents=sup.incidents, records=records, log=log,
                pids=sorted(pids))


def _step_losses(records: list[dict]) -> list[tuple[int, float]]:
    return [(int(r["step"]), float(r["loss"])) for r in records
            if r.get("kind") == "step" and "loss" in r]


def _first(records: list[dict], pred, after: float = -math.inf) -> dict | None:
    return next((r for r in records if r["t"] > after and pred(r)), None)


@contextlib.contextmanager
def kept_first_calls():
    """Keep the first calls of the BN pair (as `models/fast_bn.py` calls
    them) and the first step's blurs (as `data/augment.py` calls the
    kernel), inputs and outputs, while the block runs: yields `(kept,
    seen)` for `hold_first_calls`."""
    from moco_tpu_torch.data import augment
    from moco_tpu_torch.models import fast_bn

    kept, seen = {}, []
    real = {"sums": fast_bn.channel_sums, "grads": fast_bn.channel_grad_sums,
            "blur": augment.gaussian_blur_batch}

    def sums_kept(x):
        got = real["sums"](x)
        kept.setdefault("sums", (x.detach().clone(), [g.clone() for g in got]))
        return got

    def grads_kept(dy, x, mean, rstd):
        got = real["grads"](dy, x, mean, rstd)
        kept.setdefault("grads", (dy.detach().clone(), x.detach().clone(), mean.clone(),
                                  rstd.clone(), [g.clone() for g in got]))
        return got

    def blur_kept(images, taps, radius):
        got = real["blur"](images, taps, radius)
        if len(seen) < PER_STEP["gaussian_blur_batch"]:
            seen.append((images.cpu(), taps.cpu(), radius, got.cpu()))
        return got

    fast_bn.channel_sums, fast_bn.channel_grad_sums = sums_kept, grads_kept
    augment.gaussian_blur_batch = blur_kept
    try:
        yield kept, seen
    finally:
        fast_bn.channel_sums, fast_bn.channel_grad_sums = real["sums"], real["grads"]
        augment.gaussian_blur_batch = real["blur"]


def hold_first_calls(kept: dict, seen: list, label: str) -> dict:
    """The kept first calls of the BN pair against their plain versions on
    the path's own inputs (`SUM_RTOL`), and the blurs within one bf16 ulp
    (`_hold_blur`); returns each kernel's max abs error."""
    from moco_tpu_torch.ops import stats

    x, got = kept["sums"]
    xf = x.float()
    err_s = _sums_close("channel_sums", label, got, stats.channel_sums_plain(x),
                        (xf.abs().sum(0), (xf * xf).sum(0)))
    dy, x, mean, rstd, got = kept["grads"]
    xf, dyf = x.float(), dy.float()
    err_g = _sums_close("channel_grad_sums", label, got,
                        stats.channel_grad_sums_plain(dy, x, mean, rstd),
                        (dyf.abs().sum(0), (dyf * (xf - mean) * rstd).abs().sum(0)))
    blurred = _hold_blur(seen, label, "cuda")
    return dict(channel_sums=err_s, channel_grad_sums=err_g,
                gaussian_blur_batch=max(b["max_abs_err"] for b in blurred))


def run_supervised(counters: dict, smi: str, only_d: bool = False) -> dict:
    """Phase 11: the run supervisor on the card (see the module docstring);
    `only_d`: the four-card drill (d) alone."""
    import gc
    import signal as sig
    import tempfile

    import torch

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.data.datasets import build_dataset

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="moco_phase11_") as tmp:
        tmp = Path(tmp)

        def chaos_env(spec: str, name: str) -> dict:
            env = {k: v for k, v in os.environ.items()
                   if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MOCO_TPU_CHAOS")}
            # the children import this checkout's package from any working directory
            env["PYTHONPATH"] = os.pathsep.join(
                [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
            if spec:
                env.update(MOCO_TPU_CHAOS=spec, MOCO_TPU_CHAOS_STATE=str(tmp / name / "chaos"))
            return env

        if only_d:
            out["d"] = _resize_drill(tmp / "d", chaos_env, smi)
            return out
        # the uninterrupted run, in this process, through the phase's counters,
        # the BN pair's first calls and the first step's blurs kept
        config = get_preset("imagenet-moco-v2").replace(
            dataset="synthetic", steps_per_epoch=PHASE11_SPE, epochs=PHASE11_EPOCHS,
            print_freq=1, telemetry_dir=str(tmp / "ref" / "tel"),
            ckpt_dir=str(tmp / "ref" / "ck"), heartbeat_secs=0.0, telemetry_flush_steps=1)
        dataset = build_dataset("synthetic", image_size=config.image_size)
        torch.backends.cudnn.deterministic = True
        try:
            with kept_first_calls() as (kept, seen):
                ref = _kept_train(config, "phase11 uninterrupted", counters, dataset,
                                  PHASE11_SPE * PHASE11_EPOCHS)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        errs = hold_first_calls(kept, seen, "phase11 uninterrupted")
        err_s, err_g = errs["channel_sums"], errs["channel_grad_sums"]
        ref_losses = ref["losses"]
        print(f"phase11 uninterrupted: {ref['executed']} steps in this process, launches "
              f"{ref['launches']}; channel_sums {list(kept['sums'][0].shape)} and "
              f"channel_grad_sums {list(kept['grads'][0].shape)} on the path's own first "
              f"inputs against their plain versions (max abs err {err_s:.3e}, {err_g:.3e}); "
              f"losses {ref_losses}", flush=True)
        out["uninterrupted"] = dict(launches=ref["launches"], losses=ref_losses,
                                    max_abs_err=errs)
        del ref, kept, seen, dataset
        gc.collect()
        torch.cuda.empty_cache()

        def check_losses(label: str, records: list[dict]) -> None:
            got = _step_losses(records)
            steps = sorted({s for s, _ in got})
            bad = [(s, v, ref_losses[s - 1]) for s, v in got if v != ref_losses[s - 1]]
            if steps != list(range(1, len(ref_losses) + 1)) or bad:
                fail(f"phase11 {label}: steps {steps}, losses off the uninterrupted run's "
                     f"{bad[:4]}", 1)

        def recovery(records: list[dict], incidents: list[dict]) -> dict:
            """Death (the dead child's last step record) to the relaunched
            child's first step, split at the supervisor's exit and launch
            records."""
            exit0 = next(r for r in incidents if r["event"] == "exit")
            launch1 = [r for r in incidents if r["event"] == "launch"][1]
            last = [r for r in records if r.get("kind") == "step" and r["t"] <= exit0["t"]][-1]
            first = _first(records, lambda r: r.get("kind") == "step", launch1["t"])
            return dict(last_step=last["step"], notice_s=exit0["t"] - last["t"],
                        relaunch_s=launch1["t"] - exit0["t"],
                        child_to_first_step_s=first["t"] - launch1["t"],
                        death_to_first_step_s=first["t"] - last["t"])

        # (a) SIGKILL after step 3
        a = _supervise(_supervised_argv(tmp / "a", PHASE11_SPE, PHASE11_EPOCHS), tmp / "a",
                       chaos_env("kill_at_step=3", "a"), 120.0)
        classes = a["result"].classifications
        if classes != ["killed", "clean"]:
            fail(f"phase11 (a): classifications {classes}", 1)
        check_losses("(a)", a["records"])
        out["a"] = dict(classifications=classes, **recovery(a["records"], a["incidents"]))
        print(f"phase11 (a) SIGKILL after step 3: {classes}; every step's loss equals the "
              f"uninterrupted run's bit for bit; death to the relaunched child's first step "
              f"{out['a']['death_to_first_step_s']:.3f} s (supervisor notice "
              f"{out['a']['notice_s']:.3f} s, backoff and relaunch {out['a']['relaunch_s']:.3f}"
              f" s, child start to first step {out['a']['child_to_first_step_s']:.3f} s); no "
              f"process of the run left ({smi})", flush=True)

        # (b) a frozen child under a staleness window of PHASE11_STALE_S
        b = _supervise(_supervised_argv(tmp / "b", PHASE11_SPE, PHASE11_EPOCHS), tmp / "b",
                       chaos_env("freeze_at_step=3", "b"), PHASE11_STALE_S)
        classes = b["result"].classifications
        if classes != ["hang", "clean"]:
            fail(f"phase11 (b): classifications {classes}", 1)
        check_losses("(b)", b["records"])
        kills = [r for r in b["incidents"] if r["event"] == "kill"]
        detect = kills[0]["stale_secs"]
        if not PHASE11_STALE_S < detect <= 2 * PHASE11_STALE_S:
            fail(f"phase11 (b): the hang detected {detect} s after the last beat, window "
                 f"{PHASE11_STALE_S} s", 1)
        out["b"] = dict(classifications=classes, detect_s=detect, window_s=PHASE11_STALE_S,
                        kill_phases=[k["phase"] for k in kills],
                        **recovery(b["records"], b["incidents"]))
        print(f"phase11 (b) frozen after step 3: {classes}; detected {detect:.3f} s after the "
              f"last beat against a {PHASE11_STALE_S} s window, then "
              f"{' -> '.join(out['b']['kill_phases'])}; losses bit for bit; death (the last "
              f"beat) to the relaunched child's first step "
              f"{out['b']['death_to_first_step_s']:.3f} s ({smi})", flush=True)

        # (c) a SIGTERM to the supervised child once step 3 has run
        sent = {}

        def sigterm_after_3(sup):
            if sent:
                return
            launches = [r for r in sup.incidents if r["event"] == "launch"]
            try:
                with open(tmp / "c" / "tel" / "heartbeat.json") as f:
                    hb = json.load(f)
            except (OSError, ValueError):
                return
            if len(launches) == 1 and hb.get("phase") == "step" and hb.get("step", 0) >= 3 \
                    and hb.get("pid") == launches[0]["pid"]:
                os.kill(hb["pid"], sig.SIGTERM)
                sent.update(t=time.time(), step=hb["step"])

        c = _supervise(_supervised_argv(tmp / "c", PHASE11_SPE, PHASE11_EPOCHS), tmp / "c",
                       chaos_env("", "c"), 120.0, watch=sigterm_after_3)
        classes = c["result"].classifications
        if classes != ["preempted", "clean"] or not sent:
            fail(f"phase11 (c): classifications {classes}, SIGTERM {sent}", 1)
        check_losses("(c)", c["records"])
        end = next(r for r in c["records"] if r.get("kind") == "run_end")
        exit0 = next(r for r in c["incidents"] if r["event"] == "exit")
        out["c"] = dict(classifications=classes, sigterm_after_step=sent["step"],
                        stopped_at=end.get("last_step", end.get("step")),
                        sigterm_to_exit_s=exit0["t"] - sent["t"],
                        run_end_to_exit_s=exit0["t"] - end["t"],
                        **recovery(c["records"], c["incidents"]))
        print(f"phase11 (c) SIGTERM once step {sent['step']} ran: {classes}; the emergency "
              f"checkpoint and exit took {out['c']['run_end_to_exit_s']:.3f} s after run_end "
              f"({out['c']['sigterm_to_exit_s']:.3f} s after the signal); losses bit for bit; "
              f"the relaunched child's first step {out['c']['child_to_first_step_s']:.3f} s "
              f"after its launch ({smi})", flush=True)

        # (d) resize 4 -> 2 -> 4 cards, then a SIGTERM to one of four NCCL ranks
        out["d"] = _resize_drill(tmp / "d", chaos_env, smi)
    return out


def _resize_drill(dtmp: Path, chaos_env, smi: str) -> dict:
    """Phase 11 (d): `--num-devices 4` under the supervisor, a chaos request
    for 2 cards, the operator's request for 4, then a SIGTERM to one rank
    of four; skipped with fewer than four cards."""
    import signal as sig

    import torch

    from moco_tpu_torch.resilience.resize import argv_device_count, write_resize_request

    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"phase11 (d) skipped: {cards} card(s) here; the resize drill needs 4 "
              "(`python3 chip_smoke.py --phase11` on a host with four)", flush=True)
        return dict(skipped=f"{cards} card(s)")
    done = {}

    def drive(sup):
        try:
            with open(dtmp / "tel" / "heartbeat.json") as f:
                hb = json.load(f)
        except (OSError, ValueError):
            return
        launches = [r for r in sup.incidents if r["event"] == "launch"]
        if hb.get("phase") != "step":
            return
        if "grow" not in done and len(launches) == 2 \
                and hb.get("step", 0) >= PHASE11_D_GROW_AFTER:
            write_resize_request(str(dtmp / "tel"), devices=4)
            done["grow"] = dict(t=time.time(), step=hb["step"])
        if "term" not in done and len(launches) == 3 \
                and hb.get("step", 0) >= PHASE11_D_TERM_AFTER:
            ranks = [json.loads(line[line.index("pids [") + 5:]) for line in
                     (dtmp / "tel" / "child.log").read_text().splitlines()
                     if line.startswith("[launch]") and "pids [" in line]
            os.kill(ranks[-1][-1], sig.SIGTERM)  # one rank of four
            done["term"] = dict(t=time.time(), step=hb["step"], pid=ranks[-1][-1])

    d = _supervise(_supervised_argv(dtmp, PHASE11_D_SPE, PHASE11_D_EPOCHS,
                                    "--num-devices", "4", "--resilience-sync-steps", "1"),
                   dtmp, chaos_env(f"resize_at_step={PHASE11_D_RESIZE_AT},devices=2", "d"),
                   120.0, watch=drive)
    classes = d["result"].classifications
    launches = [r for r in d["incidents"] if r["event"] == "launch"]
    worlds = [argv_device_count(r["argv"]) for r in launches]
    if classes != ["resize", "resize", "preempted", "clean"] or worlds != [4, 2, 4, 4] \
            or d["log"].count("[exit] preemption honored") != 4:
        fail(f"phase11 (d): classifications {classes}, worlds {worlds}, "
             f"{d['log'].count('[exit] preemption honored')} ranks honored the SIGTERM", 1)
    losses = _step_losses(d["records"])
    steps = [r for r in d["records"] if r.get("kind") == "step"]
    legs = []
    for i, launch in enumerate(launches):
        until = launches[i + 1]["t"] if i + 1 < len(launches) else math.inf
        mine = [r for r in steps if launch["t"] < r["t"] < until]
        steady = sorted(r["step_s"] for r in mine[1:] if (r["step"] - 1) % PHASE11_D_SPE)
        ends = [r for r in d["records"] if r.get("kind") == "run_end"
                and launch["t"] < r["t"] < until]
        exit_i = [r for r in d["incidents"] if r["event"] == "exit"][i]
        legs.append(dict(cards=worlds[i], steps=[r["step"] for r in mine],
                         imgs_per_s=BATCH / steady[len(steady) // 2] if steady else None,
                         run_end_to_exit_s=exit_i["t"] - ends[0]["t"] if ends else None,
                         classification=classes[i]))
    if not all(math.isfinite(v) for _, v in losses) or losses[-1][0] != \
            PHASE11_D_SPE * PHASE11_D_EPOCHS:
        fail(f"phase11 (d): losses {losses}", 1)
    result = dict(classifications=classes, legs=legs, grow=done.get("grow"),
                  term=done.get("term"))
    for leg in legs:
        print(f"phase11 (d) {leg['cards']} cards ({BATCH // leg['cards']} a card), steps "
              f"{leg['steps'][0]}-{leg['steps'][-1]}: "
              f"{leg['imgs_per_s'] or math.nan:.1f} imgs/s (median steady step), ended "
              f"{leg['classification']}, run_end to exit "
              f"{leg['run_end_to_exit_s'] or math.nan:.3f} s (the elastic or emergency "
              f"checkpoint) ({smi})", flush=True)
    print(f"phase11 (d): 4 -> 2 (chaos after step {PHASE11_D_RESIZE_AT}) -> 4 (the "
          f"operator's request after step {done['grow']['step']}) cards, then a SIGTERM "
          f"to one rank (pid {done['term']['pid']}) after step {done['term']['step']} "
          f"agreed by all 4 NCCL ranks: {classes}; no process of the run left", flush=True)
    return result


PHASE12_STEPS = 4           # (c): steps of each JPEG-fed run (2 batches an epoch)
PHASE12_SERVERS = (1, 2, 4) # (c): staging servers a pool
PHASE12_D_STEPS = 8         # --phase12d: steps of each run (one epoch of 2048 images)
# --phase12d: |loss(4 cards, sync_bn) - loss(1 card)| <= rtol * |loss(1 card)|,
# fixed before the first four-card run: step 1 differs only by the order of
# f32 sums and bf16 roundings (the same global statistics), steps 2-3 carry
# those through one and two updates
PHASE12_D_RTOL = {1: 2e-3, 2: 2e-2, 3: 2e-2}


def _bn_all_reduces(config) -> int:
    """The BN all-reduces a sync_bn step issues: one a BN forward (query and
    key encoders) and one a BN backward (query), 159 for ResNet-50."""
    per_step = PER_STEP["channel_sums"] + PER_STEP["channel_grad_sums"]
    return per_step if config.sync_bn else 0


def _service_batches(spec: str, dataset_len: int, config, epoch: int = 0) -> list:
    """The first `epoch`'s batches as `service_epoch_loader` stages them onto
    the card (the driver's knobs), copied."""
    from moco_tpu_torch.data.service.client import service_epoch_loader

    loader = service_epoch_loader(spec, dataset_len, epoch, config.seed, config.batch_size,
                                  "cuda", depth=config.prefetch_depth,
                                  streams=config.staging_workers)
    try:
        return [tuple(t.clone() for t in batch) for batch in loader]
    finally:
        loader.close_quietly()


def _same_batches(got: list, want: list, label: str) -> None:
    import torch

    if len(got) != len(want) or not got or not all(
            a.dtype == b.dtype and torch.equal(a, b)
            for g, w in zip(got, want) for a, b in zip(g, w)):
        fail(f"{label}: the service's batches differ from the in-process loader's", 1)


def _relaunch_seconds(events_path: Path) -> float:
    """From the killed worker's `worker_exit` record to the relaunched
    worker's first healthy probe, on the server's events.jsonl clock."""
    with open(events_path, encoding="utf-8") as f:
        events = [json.loads(line) for line in f]
    died = next(e for e in events if e["event"] == "worker_exit" and e["returncode"] == -9)
    back = next(e for e in events if e["t"] >= died["t"]
                and e["event"] in ("worker_healthy", "readmit"))
    return back["t"] - died["t"]


def run_sync_bn_and_service(counters: dict, smi: str) -> dict:
    """Phase 12: `sync_bn` and the input service on one card (see the module
    docstring)."""
    import tempfile

    import torch

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.data.datasets import build_dataset
    from moco_tpu_torch.data.loader import epoch_loader
    from moco_tpu_torch.data.service.fleet import LocalServerPool
    from moco_tpu_torch.data.service.prestage import PrestagedDataset, write_prestage
    from moco_tpu_torch.data.stats import InputPipelineStats
    from moco_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed
    from moco_tpu_torch.serve.fleet import FleetPolicy

    out = {"cpu_count": os.cpu_count()}
    base = get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", batch_size=BATCH, staging_workers=4, prefetch_depth=2,
        print_freq=1)
    dataset = build_dataset("synthetic", image_size=base.image_size)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory(prefix="moco_phase12_") as tmp:
        tmp = Path(tmp)
        # (a), (b), (e): sync_bn in a one-rank NCCL group
        init_distributed("cuda", rank=0, world_size=1, init_method=f"file://{tmp / 'store'}")
        try:
            runs = {}
            for label, config in (("off", base), ("sync_bn", base.replace(sync_bn=True))):
                with kept_first_calls() as (kept, seen):
                    r = counted_train(config, f"phase12 (a) {label}", counters, dataset,
                                      DIST_STEPS)
                want = 3 + _bn_all_reduces(config)
                if r["calls"]["all_reduce"] != want * DIST_STEPS:
                    fail(f"phase12 (a) {label}: {r['calls']['all_reduce']} all-reduces in "
                         f"{DIST_STEPS} steps, expected {want} a step", 1)
                r["held"] = hold_first_calls(kept, seen, f"phase12 (a) {label}")
                runs[label] = r
                del kept, seen
            compare_runs(runs["sync_bn"], runs["off"], "phase12 (a) sync_bn vs off, one-rank "
                         "NCCL group", DIST_STEPS)
            fused = counted_train(base.replace(sync_bn=True, fused_bn_conv=True),
                                  "phase12 (b) fused_bn_conv + sync_bn", counters, dataset, 2)
        finally:
            shutdown_distributed()
            torch.backends.cudnn.deterministic = deterministic
        out["a"] = {label: dict(losses=r["losses"], launches=r["launches"],
                                all_reduce_per_step=r["calls"]["all_reduce"] / DIST_STEPS,
                                imgs_per_s=r["imgs_per_s"], max_abs_err=r["held"])
                    for label, r in runs.items()}
        out["b"] = {k: fused["launches"][k] for k in FUSED_PER_STEP}
        del runs, fused
        print(f"phase12 (a) sync_bn in a one-rank NCCL group equals per-process BN bit for "
              f"bit; all-reduces a step {out['a']['sync_bn']['all_reduce_per_step']:.0f} vs "
              f"{out['a']['off']['all_reduce_per_step']:.0f}; imgs/s "
              f"{out['a']['sync_bn']['imgs_per_s']:.1f} vs {out['a']['off']['imgs_per_s']:.1f}"
              f" (deterministic cuDNN, steps 2-{DIST_STEPS}); the BN pair and the blur on "
              f"the path's first inputs against their plain versions "
              f"{out['a']['sync_bn']['max_abs_err']}; (b) fused_bn_conv + sync_bn launches "
              f"of kernels 4-8: {out['b']} ({smi})", flush=True)
        del dataset
        torch.cuda.empty_cache()

        # (c), (d): phase 4's JPEG tree through the staging servers
        tree = tmp / "jpeg"
        write_jpeg_tree(tree)
        folder = base.replace(dataset="imagefolder", data_dir=str(tree), stage_size=512)
        # phase 4's decoder, in this process and in the servers' workers
        local = build_dataset("imagefolder", str(tree), stage_size=512,
                              backend=IMAGEFOLDER_BACKEND)
        worker_args = ["--dataset", "imagefolder", "--data-dir", str(tree),
                       "--stage-size", "512", "--backend", IMAGEFOLDER_BACKEND]
        policy = FleetPolicy(probe_secs=0.2, startup_grace_secs=60.0, backoff_base_secs=0.1,
                             backoff_max_secs=0.5)
        loader = epoch_loader(local, 0, folder.seed, BATCH, "cuda", workers=4)
        try:
            want = [tuple(t.clone() for t in batch) for batch in loader]
        finally:
            loader.close_quietly()
        rates, staging = {}, {}

        def fed(label, config, data):
            stats = InputPipelineStats()
            rates[label] = counted_train(config, f"phase12 (c) {label}", counters, data,
                                         PHASE12_STEPS, stats=stats)["imgs_per_s"]
            snap = stats.snapshot()
            staging[label] = {k: snap[k] for k in ("staged_batch_s_p50", "staged_batch_s_p95",
                                                   "credit_stall_s")}

        fed("in-process PIL", folder, local)
        root = str(tmp / "prestage")
        write_prestage(local, root)
        fed("in-process prestage", folder.replace(input_prestage=root), PrestagedDataset(root))
        for n in PHASE12_SERVERS:
            pool = LocalServerPool(n, worker_args, telemetry_root=str(tmp / f"pool{n}"),
                                   policy=policy)
            try:
                pool.start()
                if not pool.wait_healthy(120.0):
                    fail(f"phase12 (c): a pool of {n} staging servers never became healthy", 1)
                _same_batches(_service_batches(pool.endpoints_spec(), len(local), folder),
                              want, f"phase12 (c) {n} server(s)")
                fed(f"{n} server(s)", folder.replace(input_service=pool.endpoints_spec()),
                    None)
            finally:
                pool.close_quietly()
        out["c"] = dict(imgs_per_s=rates, staging=staging)
        print(f"phase12 (c) the driver fed from {IMAGEFOLDER_IMAGES} JPEGs (batch {BATCH}, "
              f"steps 2-{PHASE12_STEPS}, {os.cpu_count()} host cores): " + ", ".join(
                  f"{k} {v:.1f} imgs/s (staged batch p50/p95 "
                  f"{staging[k]['staged_batch_s_p50']:.3f}/"
                  f"{staging[k]['staged_batch_s_p95']:.3f} s, credit stall "
                  f"{staging[k]['credit_stall_s']:.2f} s)" for k, v in rates.items())
              + f"; each pool's first epoch equal to the in-process loader's bit for bit "
              f"({smi})", flush=True)

        # (d): kill_at_shard on one of two servers, mid-epoch
        pool = LocalServerPool(2, worker_args, telemetry_root=str(tmp / "drill"), policy=policy,
                               per_server_env={0: {
                                   "MOCO_TPU_CHAOS": "kill_at_shard=2",
                                   "MOCO_TPU_CHAOS_STATE": str(tmp / "drill" / "chaos")}})
        try:
            pool.start()
            if not pool.wait_healthy(120.0):
                fail("phase12 (d): the drill's pool never became healthy", 1)
            t0 = time.perf_counter()
            _same_batches(_service_batches(pool.endpoints_spec(), len(local), folder), want,
                          "phase12 (d) kill_at_shard")
            epoch_s = time.perf_counter() - t0
            server0 = pool.servers[0]
            deadline = time.monotonic() + 120.0
            while not (server0.worker.launches >= 2 and server0.worker_healthy()):
                if time.monotonic() > deadline:
                    fail("phase12 (d): the killed worker was not relaunched", 1)
                time.sleep(0.1)
            relaunch_s = _relaunch_seconds(tmp / "drill" / "staging_server0" / "events.jsonl")
        finally:
            pool.close_quietly()
        out["d"] = dict(epoch_s=epoch_s, relaunch_s=relaunch_s)
        print(f"phase12 (d) kill_at_shard=2 on one of two servers: the epoch equal to the "
              f"in-process loader's bit for bit in {epoch_s:.2f} s; the killed worker "
              f"healthy again {relaunch_s:.2f} s after its death ({smi})", flush=True)
    return out


def sync_bn_across_cards(smi: str) -> dict:
    """`--phase12d`: the driver's CLI at `--num-devices 4 --sync-bn true`
    (64 a card) against one card at 256 without it, and at four cards
    without it; skipped with fewer than four cards."""
    import re

    import torch

    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"phase12d skipped: {cards} card(s) here; it needs 4 on one host",
              flush=True)
        return dict(skipped=f"{cards} card(s)")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    argv = [sys.executable, "-m", "moco_tpu_torch.train", "--preset", "imagenet-moco-v2",
            "--dataset", "synthetic", "--max-steps", str(PHASE12_D_STEPS), "--print-freq", "1"]
    runs = {}
    for label, extra in (("1 card", []),
                         ("4 cards sync_bn", ["--num-devices", "4", "--sync-bn", "true"]),
                         ("4 cards", ["--num-devices", "4"])):
        proc = subprocess.run(argv + extra, env=env, capture_output=True, text=True,
                              timeout=600)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / f"phase12d_{label.replace(' ', '_')}.log").write_text(
            proc.stdout + proc.stderr)
        steps = [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
            r"^step (\d+) loss (\S+) .* imgs_s (\S+)$", proc.stdout, re.M)]
        if proc.returncode != 0 or len(steps) != PHASE12_D_STEPS:
            fail(f"phase12d {label}: exit {proc.returncode}, {len(steps)} steps:\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}", 1)
        rates = sorted(r for _, _, r in steps[2:])
        runs[label] = dict(losses=[v for _, v, _ in steps], imgs_per_s=rates[len(rates) // 2])
    one, synced = runs["1 card"]["losses"], runs["4 cards sync_bn"]["losses"]
    for step, rtol in PHASE12_D_RTOL.items():
        if abs(synced[step - 1] - one[step - 1]) > rtol * abs(one[step - 1]):
            fail(f"phase12d: step {step} loss {synced[step - 1]} at 4 cards with sync_bn vs "
                 f"{one[step - 1]} on one card, beyond rtol {rtol}", 1)
    print(f"phase12d: 4 cards x 64 with sync_bn vs 1 card x 256: losses {synced[:3]} vs "
          f"{one[:3]} (rtol {PHASE12_D_RTOL}); median imgs/s over steps 3-{PHASE12_D_STEPS}: "
          + ", ".join(f"{k} {v['imgs_per_s']:.1f}" for k, v in runs.items()) + f" ({smi})",
          flush=True)
    return runs


def _v3_states_differ(a, b) -> list[str]:
    """What differs between two v3 TrainStates, bit for bit."""
    import torch

    diff = []
    for name in ("model_q", "model_k"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        diff += [f"{name}.{k}" for k in sb if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    if oa.keys() != ob.keys() or not ob:
        diff.append("optimizer state")
    diff += [f"optimizer {i}.{k}" for i in ob if i in oa for k in ob[i]
             if not torch.equal(torch.as_tensor(oa[i][k]), torch.as_tensor(ob[i][k]))]
    if a.step != b.step:
        diff.append(f"step {a.step} != {b.step}")
    for g in ("generator", "data_generator"):
        if not torch.equal(getattr(a, g).get_state(), getattr(b, g).get_state()):
            diff.append(g)
    return diff


def v3_across_cards(counters: dict, dataset) -> dict:
    """`--phase8` under torchrun: (a) over every card in one NCCL group at
    V3_RANK_BATCH a card (the preset's global 4096 on four), remat on."""
    from moco_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed, world_size

    device = init_distributed("cuda")
    try:
        from moco_tpu_torch.parallel.mesh import process_group

        n = world_size(process_group())
        config, r, prof = _v3_vits(counters, dataset, V3_RANK_BATCH * n, V3_STEPS,
                                   f"phase8 vits {n} cards", remat=True, device=device)
        return dict(ranks=n, global_batch=config.batch_size, remat=config.remat,
                    imgs_per_s=r["imgs_per_s"], max_memory_gib=r["max_memory_gib"],
                    losses=r["losses"], busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                    attention_ms=prof["attention_ms"], blur=r["blur"])
    finally:
        shutdown_distributed()


PHASE13_BUCKETS = (1, 8, 32, 128)
PHASE13_CLIENTS = 32        # (b), (c): closed-loop HTTP clients, one keep-alive connection each
PHASE13_REQUESTS = 1024     # (b): requests in the timed run
PHASE13_POOL = 64           # distinct 224 px images the clients send (the cache is off)
PHASE13_RELOAD_LEAD_S = 1.0  # (c): load before the reload is posted, and after it returns
PHASE13_CPU_ROWS = 8        # (a): rows held against the CPU f32 forward of the same weights
PHASE13_BANK = 1024         # (d): bank rows (SyntheticDataset, 10 classes), its shards
PHASE13_BANK_SHARDS = 4
PHASE13_CELLS = 32          # (d): ANN coarse cells, nprobe 8 (the ServeConfig default)
PHASE13_QUERIES = 64        # (d): /v1/knn queries against the exact and the ANN service
PHASE13_ROW_RTOL = 1e-4     # (b)-(c): |served - engine row| <= rtol * max |row| (another bucket)
OPT_STEPS = 5               # (e): steps of each optimizer on ResNet-50's parameters
OPT_LARS_RTOL = 1e-6        # (e): max |p_zero - p_plain| <= rtol * max |p| (LARS; AdamW exact)


def check_sharded_optimizers(group, device, label: str) -> dict:
    """`ShardedAdamW` and `ShardedLARS` over `group` against the plain
    `AdamW` and `LARS` on ResNet-50's parameter shapes (25.6M f32), OPT_STEPS
    steps of the same seeded gradients on every rank: AdamW bit for bit, LARS
    within OPT_LARS_RTOL, every rank's parameters equal, the state bytes a
    rank holds against the plain optimizer's, and each step's time (CUDA
    events, the mean over steps 2-5)."""
    import torch
    import torch.distributed as dist

    from moco_tpu_torch.models import build_backbone
    from moco_tpu_torch.ops.optim import LARS, AdamW
    from moco_tpu_torch.parallel.mesh import rank, world_size
    from moco_tpu_torch.parallel.zero import ShardedAdamW, ShardedLARS

    n, me = world_size(group), rank(group)
    shapes = [p.shape for p in build_backbone("resnet50").parameters()]
    kws = {"adamw": dict(lr=1.5e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1),
           "lars": dict(lr=0.3, weight_decay=1.5e-6, momentum=0.9)}
    classes = {"adamw": (AdamW, ShardedAdamW), "lars": (LARS, ShardedLARS)}
    out = {}
    for name, kw in kws.items():
        runs = {}
        for kind, make in (("plain", lambda ps: classes[name][0](ps, **kw)),
                           ("zero", lambda ps: classes[name][1](ps, group, **kw))):
            gen = torch.Generator(device=device).manual_seed(13)
            params = [torch.nn.Parameter(torch.randn(s, generator=gen, device=device))
                      for s in shapes]
            opt = make(params)
            times = []
            for _ in range(OPT_STEPS):
                for p in params:
                    p.grad = torch.randn(p.shape, generator=gen, device=device)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                opt.step()
                end.record()
                times.append((start, end))
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in times][1:]
            nbytes = sum(v.numel() * v.element_size() for s in opt.state.values()
                         for v in s.values() if isinstance(v, torch.Tensor))
            runs[kind] = dict(params=params, ms=sum(ms) / len(ms), bytes=nbytes)
        worst = 0.0
        for p, z in zip(runs["plain"]["params"], runs["zero"]["params"]):
            p, z = p.detach(), z.detach()
            worst = max(worst, float((p - z).abs().max() / p.abs().max()))
        if name == "adamw" and worst != 0.0:
            fail(f"{label} ShardedAdamW differs from AdamW by {worst:.3e} of max |p|", 1)
        if worst > OPT_LARS_RTOL:
            fail(f"{label} ShardedLARS differs from LARS by {worst:.3e} of max |p| "
                 f"(tolerance {OPT_LARS_RTOL:g})", 1)
        if group is not None and n > 1:
            flat = torch.cat([p.detach().reshape(-1) for p in runs["zero"]["params"]])
            ref = flat.clone()
            dist.broadcast(ref, 0, group=group)
            if not torch.equal(flat, ref):
                fail(f"{label} {name}: the ranks' parameters differ after the sharded steps", 1)
        out[name] = dict(max_rel_diff=worst, plain_ms=runs["plain"]["ms"],
                         zero_ms=runs["zero"]["ms"], plain_bytes=runs["plain"]["bytes"],
                         zero_bytes=runs["zero"]["bytes"])
        if me == 0:
            print(f"{label} {name}: {n} rank(s), {len(shapes)} ResNet-50 tensors, "
                  f"{OPT_STEPS} steps: max |p_zero - p_plain| / max |p| {worst:.3e} "
                  f"({'bit for bit' if worst == 0 else f'tolerance {OPT_LARS_RTOL:g}'}), "
                  f"step {runs['zero']['ms']:.3f} ms sharded vs {runs['plain']['ms']:.3f} ms "
                  f"plain, state {runs['zero']['bytes']} bytes a rank vs "
                  f"{runs['plain']['bytes']}", flush=True)
        del runs
        torch.cuda.empty_cache()
    return out


def _serve_load(url: str, bodies: list, clients: int, total: int | None = None,
                stop=None) -> tuple[list, float]:
    """Closed-loop clients, one keep-alive connection each, POSTing
    `bodies` round-robin to /v1/embed until `total` requests were sent (or
    `stop` is set); returns ([(client, t0, t1, status, body bytes, pool
    index)], wall seconds)."""
    import http.client
    import threading
    import urllib.parse

    host, port = urllib.parse.urlsplit(url).netloc.split(":")
    records, errors = [], []
    lock = threading.Lock()
    sent = [0]

    def client(c: int) -> None:
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        i = c
        try:
            while not (stop is not None and stop.is_set()):
                with lock:
                    if total is not None and sent[0] >= total:
                        break
                    sent[0] += 1
                k = i % len(bodies)
                i += clients
                t0 = time.perf_counter()
                conn.request("POST", "/v1/embed", body=bodies[k],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                records.append((c, t0, time.perf_counter(), resp.status, data, k))
        except Exception as e:  # noqa: BLE001 - a client failure fails the phase
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"phase13: {len(errors)} client(s) failed: {errors[:3]}", 1)
    return records, wall


def _percentile_ms(values: list, q: float) -> float:
    ordered = sorted(values)
    return 1e3 * ordered[max(0, min(len(ordered) - 1, round(q / 100 * (len(ordered) - 1))))]


@contextlib.contextmanager
def _serving_dir(workdir, prefix: str):
    """`workdir` as a Path when given (phases 13 and 14 share their exports
    and bank there), else a temporary directory of this call's own."""
    if workdir is not None:
        yield Path(workdir)
        return
    import tempfile

    with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
        yield Path(tmp)


def _serving_exports(tmp: Path) -> list[str]:
    """Two ResNet-50 exports (224 px) of freshly initialized imagenet-moco-v2
    states, seeds 0 and 1, as `tmp/export/<seed + 1>/encoder.npz`; made once
    a directory."""
    import torch

    from moco_tpu_torch import checkpoint as ckpt
    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder

    paths = [tmp / "export" / str(seed + 1) / "encoder.npz" for seed in (0, 1)]
    if all(p.is_file() for p in paths):
        return [str(p) for p in paths]
    config = get_preset("imagenet-moco-v2").replace(dataset="synthetic")
    for seed, path in enumerate(paths):
        state = create_train_state(config.replace(seed=seed),
                                   build_encoder(config.replace(seed=seed)), "cuda", seed=seed)
        path.parent.mkdir(parents=True, exist_ok=True)
        ckpt.export_encoder_q(state, str(path))
        del state
    torch.cuda.empty_cache()
    return [str(p) for p in paths]


def _serving_bank(tmp: Path, export: str, engine, label: str) -> tuple[str, float, float]:
    """The versioned bank of PHASE13_BANK rows (SyntheticDataset, 10 classes)
    built through `engine` on `export` in PHASE13_BANK_SHARDS shards as step
    2 under `tmp/bank`, and its PHASE13_CELLS-cell IVF index, both verified;
    returns (bank path, build seconds, index seconds)."""
    import numpy as np

    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.serve import ann as annmod
    from moco_tpu_torch.serve import bankbuild

    bank_set = SyntheticDataset(num_samples=PHASE13_BANK, image_size=224, seed=0)
    cap = PHASE13_BUCKETS[-1]

    def embed_fn(batch):
        return np.concatenate([engine.embed(batch[i:i + cap]) for i in range(0, len(batch), cap)])

    bank_dir = tmp / "bank"
    manifest, build_s = _cuda_time(lambda: bankbuild.build_bank(
        str(bank_dir), 2, bank_set.images, bank_set.labels, embed_fn, checkpoint_path=export,
        image_size=224, shards=PHASE13_BANK_SHARDS, workers=2, batch_rows=cap))
    t0 = time.perf_counter()
    annmod.build_ann_index(str(bank_dir), 2, cells=PHASE13_CELLS)
    ann_s = time.perf_counter() - t0
    bad = bankbuild.verify_bank(str(bank_dir), 2), annmod.verify_ann(str(bank_dir), 2)
    if bad != (None, None) or manifest["rows"] != PHASE13_BANK:
        fail(f"{label}: the bank or its index does not verify: {bad}", 1)
    return str(bank_dir / "2" / "bank.npz"), build_s, ann_s


def run_serving(counters: dict, smi: str, workdir=None) -> dict:
    """Phase 13, the embedding service on one card: (a) a ResNet-50 export
    (224 px) of a freshly initialized imagenet-moco-v2 state, served by the
    engine over buckets PHASE13_BUCKETS: one CUDA graph a bucket, the
    capture's seconds, each bucket's graph against the eager forward of the
    same batch (bit for bit), an image among other neighbours in the same
    bucket (bit for bit), the largest difference across buckets, and
    PHASE13_CPU_ROWS rows against the CPU f32 forward of the same weights;
    (b) the HTTP front end under PHASE13_CLIENTS closed-loop clients,
    PHASE13_REQUESTS requests: requests/s, latency p50/p99, batch occupancy,
    no error, the served rows against the engine's, `compiled_programs()`
    still 4; (c) a hot reload to a second export under that load: no
    request dropped, each client's answers from the old engine and then the
    new one only, the reload's seconds; (d) a versioned bank of
    PHASE13_BANK rows built through the engine in PHASE13_BANK_SHARDS
    shards, `verify_bank`, an ANN index (`verify_ann`), and /v1/knn of
    PHASE13_QUERIES queries against the exact and the ANN service; (e)
    `ShardedAdamW` and `ShardedLARS` in a one-rank NCCL group against the
    plain optimizers. None of the eight kernels runs on this path (the
    engine's BatchNorms use their running statistics): their launches stay
    0."""
    import base64
    import json as _json
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from moco_tpu_torch.config import ServeConfig
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, \
        shutdown_distributed
    from moco_tpu_torch.serve import EmbeddingEngine, EmbedService, ServeFrontend
    from moco_tpu_torch.serve.__main__ import build_service

    for fn in counters.values():
        fn.launches = 0
    out = {}
    with _serving_dir(workdir, "moco_phase13_") as tmp:
        paths = _serving_exports(tmp)
        # (a) the engine: one CUDA graph a bucket
        engine, load_s = _cuda_time(lambda: EmbeddingEngine.from_checkpoint(
            paths[0], "resnet50", image_size=224, buckets=PHASE13_BUCKETS))
        feat_dim, warm_s = _cuda_time(engine.warmup)
        if engine.compiled_programs() != len(PHASE13_BUCKETS) or feat_dim != 2048:
            fail(f"phase13 (a): {engine.compiled_programs()} graphs, feat_dim {feat_dim}", 1)
        imgs = np.random.RandomState(13).randint(0, 256, (128, 224, 224, 3)).astype(np.uint8)
        buckets = {}
        for b in PHASE13_BUCKETS:
            x = imgs[:b]
            got = engine.embed(x)
            with torch.no_grad():
                eager = engine._forward(torch.from_numpy(x).cuda()).cpu().numpy()
            rolled = engine.embed(np.roll(x, 1, axis=0))
            if not np.array_equal(got, eager):
                fail(f"phase13 (a) bucket {b}: the graph differs from the eager forward by "
                     f"{float(np.abs(got - eager).max()):.3e}", 1)
            if not np.array_equal(np.roll(got, 1, axis=0), rolled):
                fail(f"phase13 (a) bucket {b}: rows change with their neighbours by "
                     f"{float(np.abs(np.roll(got, 1, axis=0) - rolled).max()):.3e}", 1)
            graph, static_in, _ = engine._graphs[b]
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(5):
                graph.replay()
            end.record()
            torch.cuda.synchronize()
            xin = torch.from_numpy(x).cuda()
            with torch.no_grad():
                _, eager_s = _cuda_time(lambda: [engine._forward(xin) for _ in range(5)])
            t0 = time.perf_counter()
            for _ in range(5):
                engine.embed(x)
            embed_ms = (time.perf_counter() - t0) / 5 * 1e3
            buckets[b] = dict(graph_ms=start.elapsed_time(end) / 5, eager_ms=eager_s / 5 * 1e3,
                              embed_ms=embed_ms, rows=got)
        ref1 = buckets[1]["rows"]
        cross = max(float(np.abs(buckets[b]["rows"][:1] - ref1).max()) for b in PHASE13_BUCKETS)
        cross8 = max(float(np.abs(buckets[b]["rows"][:8] - buckets[8]["rows"]).max())
                     for b in (32, 128))
        scale = float(np.abs(buckets[128]["rows"]).max())
        cpu_engine = EmbeddingEngine.from_checkpoint(paths[0], "resnet50", image_size=224,
                                                     buckets=(PHASE13_CPU_ROWS,), device="cpu")
        cpu_rows = cpu_engine.embed(imgs[:PHASE13_CPU_ROWS])
        cpu_err = float(np.abs(buckets[8]["rows"] - cpu_rows).max())
        del cpu_engine
        if cpu_err > FEATURE_ATOL * max(1.0, float(np.abs(cpu_rows).max())):
            fail(f"phase13 (a): card vs CPU rows differ by {cpu_err:.3e}", 1)
        for b in PHASE13_BUCKETS:
            r = buckets[b]
            print(f"phase13 (a) bucket {b}: graph replay {r['graph_ms']:.3f} ms vs eager "
                  f"{r['eager_ms']:.3f} ms ({b / r['graph_ms'] * 1e3:.1f} imgs/s on the "
                  f"device), embed() with copies {r['embed_ms']:.3f} ms; graph = eager and "
                  "rows independent of their neighbours, bit for bit", flush=True)
        print(f"phase13 (a): resnet50 export loaded in {load_s:.2f} s, {len(PHASE13_BUCKETS)} "
              f"CUDA graphs captured in {warm_s:.2f} s; across buckets the same image "
              f"differs by up to {cross:.3e} (row 0 in 1/8/32/128) and {cross8:.3e} (rows 0-7 "
              f"in 8/32/128), max |row| {scale:.3f}; card vs CPU f32 on {PHASE13_CPU_ROWS} "
              f"rows {cpu_err:.3e} (tolerance {FEATURE_ATOL:g} x max(1, max |row|))",
              flush=True)
        out["a"] = dict(load_s=load_s, warm_s=warm_s, cross_bucket=cross, cross8=cross8,
                        cpu_err=cpu_err, scale=scale,
                        buckets={b: {k: v for k, v in r.items() if k != "rows"}
                                 for b, r in buckets.items()})
        # (b) the front end under 32 closed-loop clients, the cache off
        serve_cfg = ServeConfig(pretrained=paths[0], arch="resnet50", port=0,
                                embed_cache_mb=0, buckets=PHASE13_BUCKETS)
        service = EmbedService(
            engine, flush_ms=serve_cfg.flush_ms, max_queue=serve_cfg.max_queue,
            request_deadline_ms=serve_cfg.request_deadline_ms, cache_mb=0,
            reload_probe=serve_cfg.reload_probe, reload_min_spread=serve_cfg.reload_min_spread)
        service.set_engine_factory(lambda p: EmbeddingEngine.from_checkpoint(
            p, "resnet50", image_size=224, buckets=PHASE13_BUCKETS))
        frontend = ServeFrontend(service, "127.0.0.1", 0)
        frontend.start()
        pool = imgs[:PHASE13_POOL]
        bodies = [_json.dumps({"image_b64": base64.b64encode(im.tobytes()).decode("ascii"),
                               "shape": list(im.shape)}).encode() for im in pool]
        old_rows = engine.embed(pool)
        try:
            _serve_load(frontend.url, bodies, PHASE13_CLIENTS, total=2 * PHASE13_CLIENTS)
            before = service.stats()
            records, wall = _serve_load(frontend.url, bodies, PHASE13_CLIENTS,
                                        total=PHASE13_REQUESTS)
            stats = service.stats()
            bad = [r for r in records if r[3] != 200]
            if bad or len(records) != PHASE13_REQUESTS:
                fail(f"phase13 (b): {len(records)} answers, {len(bad)} not 200: "
                     f"{bad[0][4][:200] if bad else b''}", 1)
            row_err = max(float(np.abs(np.asarray(_json.loads(r[4])["embedding"], np.float32)
                                       - old_rows[r[5]]).max()) for r in records)
            if row_err > PHASE13_ROW_RTOL * scale:
                fail(f"phase13 (b): served rows differ from the engine's by {row_err:.3e}", 1)
            if engine.compiled_programs() != len(PHASE13_BUCKETS):
                fail(f"phase13 (b): {engine.compiled_programs()} graphs after the load", 1)
            lat = [r[2] - r[1] for r in records]
            batches = stats["batches"] - before["batches"]
            out["b"] = dict(rps=len(records) / wall, p50_ms=_percentile_ms(lat, 50),
                            p99_ms=_percentile_ms(lat, 99), batches=batches,
                            occupancy=stats["occupancy_mean"], row_err=row_err,
                            server_p50_ms=stats["latency_ms"]["p50"],
                            server_p99_ms=stats["latency_ms"]["p99"])
            print(f"phase13 (b): {PHASE13_CLIENTS} clients, {len(records)} requests in "
                  f"{wall:.2f} s: {out['b']['rps']:.1f} requests/s, latency p50 "
                  f"{out['b']['p50_ms']:.1f} ms p99 {out['b']['p99_ms']:.1f} ms (the "
                  f"service's own p50 {stats['latency_ms']['p50']} p99 "
                  f"{stats['latency_ms']['p99']} ms), {batches} batches, mean occupancy "
                  f"{stats['occupancy_mean']} (cumulative), 0 errors, served rows within "
                  f"{row_err:.3e} of the engine's, {engine.compiled_programs()} CUDA graphs; "
                  f"host cores {os.cpu_count()}", flush=True)
            # (c) a hot reload under that load
            stop = threading.Event()
            result = {}

            def reload():
                time.sleep(PHASE13_RELOAD_LEAD_S)
                req = urllib.request.Request(
                    frontend.url + "/admin/reload",
                    data=_json.dumps({"pretrained": paths[1], "step": 2}).encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
                result["t0"] = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as resp:
                    result["status"], result["body"] = resp.status, _json.loads(resp.read())
                result["t1"] = time.perf_counter()
                time.sleep(PHASE13_RELOAD_LEAD_S)
                stop.set()

            reloader = threading.Thread(target=reload)
            reloader.start()
            try:
                records, wall = _serve_load(frontend.url, bodies, PHASE13_CLIENTS, stop=stop)
            finally:
                stop.set()
                reloader.join()
            if result.get("status") != 200:
                fail(f"phase13 (c): the reload answered {result}", 1)
            new_engine = service.engine
            new_rows = new_engine.embed(pool)
            gens, last = [], {}
            for c, t0, t1, status, data, k in sorted(records, key=lambda r: r[1]):
                if status != 200:
                    fail(f"phase13 (c): a request answered {status}: {data[:200]}", 1)
                row = np.asarray(_json.loads(data)["embedding"], np.float32)
                err_old = float(np.abs(row - old_rows[k]).max())
                err_new = float(np.abs(row - new_rows[k]).max())
                gen = 0 if err_old <= PHASE13_ROW_RTOL * scale else \
                    1 if err_new <= PHASE13_ROW_RTOL * scale else None
                if gen is None or gen < last.get(c, 0) or (t0 > result["t1"] and gen == 0):
                    fail(f"phase13 (c): client {c}'s answer fits no engine in order (old "
                         f"{err_old:.3e}, new {err_new:.3e}, generation {gen})", 1)
                last[c] = gen
                gens.append(gen)
            if new_engine.compiled_programs() != len(PHASE13_BUCKETS) or not (
                    0 < sum(gens) < len(gens)):
                fail(f"phase13 (c): {new_engine.compiled_programs()} graphs, {sum(gens)} of "
                     f"{len(gens)} answers from the new engine", 1)
            body = result["body"]
            out["c"] = dict(requests=len(records), rps=len(records) / wall,
                            reload_s=result["t1"] - result["t0"], warm_s=body["warm_s"],
                            old=len(gens) - sum(gens), new=sum(gens),
                            probe_drift=body.get("probe_drift"),
                            probe_spread=body.get("probe_spread"))
            print(f"phase13 (c): reload under {PHASE13_CLIENTS} clients: {len(records)} "
                  f"requests in {wall:.2f} s ({out['c']['rps']:.1f}/s), all 200, "
                  f"{out['c']['old']} from the old engine then {out['c']['new']} from the new "
                  f"in every client's order; POST /admin/reload took "
                  f"{out['c']['reload_s']:.2f} s (load + capture {body['warm_s']} s), probe "
                  f"drift {body.get('probe_drift')} spread {body.get('probe_spread')}; "
                  f"{new_engine.compiled_programs()} CUDA graphs", flush=True)
        finally:
            service.drain(timeout_s=60.0)
            frontend.shutdown()
        # (d) a versioned bank through the new engine, an ANN index, /v1/knn
        query_set = SyntheticDataset(num_samples=PHASE13_QUERIES, image_size=224, seed=999)
        bank_path, build_s, ann_s = _serving_bank(tmp, paths[1], new_engine, "phase13 (d)")
        del new_engine, engine
        torch.cuda.empty_cache()
        classes = {}
        for kind, extra in (("exact", {}), ("ann", dict(ann_cells=PHASE13_CELLS))):
            cfg = ServeConfig(pretrained=paths[1], arch="resnet50", port=0, embed_cache_mb=0,
                              buckets=PHASE13_BUCKETS, knn_bank=bank_path, num_classes=10,
                              **extra)
            service, _ = build_service(cfg, "cuda")
            frontend = ServeFrontend(service, "127.0.0.1", 0)
            frontend.start()
            try:
                got = []
                for im in query_set.images:
                    req = urllib.request.Request(
                        frontend.url + "/v1/knn", data=_json.dumps(
                            {"image_b64": base64.b64encode(im.tobytes()).decode("ascii"),
                             "shape": list(im.shape)}).encode(),
                        headers={"Content-Type": "application/json"}, method="POST")
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        got.append(_json.loads(resp.read())["class"])
                classes[kind] = np.asarray(got)
                if kind == "ann":
                    recall = service.stats()["ann"]["recall_probe"]
                if service.engine.compiled_programs() != len(PHASE13_BUCKETS):
                    fail(f"phase13 (d): {service.engine.compiled_programs()} graphs", 1)
            finally:
                service.drain(timeout_s=60.0)
                frontend.shutdown()
            del service
            torch.cuda.empty_cache()
        agree = float(np.mean(classes["exact"] == classes["ann"]))
        acc = {k: float(np.mean(v == query_set.labels)) for k, v in classes.items()}
        out["d"] = dict(build_s=build_s, ann_s=ann_s, agreement=agree, top1=acc,
                        recall_probe=recall)
        print(f"phase13 (d): bank of {PHASE13_BANK} rows x 2048 built in "
              f"{PHASE13_BANK_SHARDS} shards in {build_s:.2f} s, verify_bank ok; ANN index "
              f"({PHASE13_CELLS} cells) in {ann_s:.2f} s, verify_ann ok; /v1/knn on "
              f"{PHASE13_QUERIES} queries: exact vs ANN agreement {agree:.3f}, top-1 exact "
              f"{acc['exact']:.3f} ANN {acc['ann']:.3f}, ANN recall probe {recall}", flush=True)
    launched = {name: fn.launches for name, fn in counters.items() if fn.launches}
    if launched:
        fail(f"phase13: the serving path launched training kernels: {launched}", 1)
    # (e) the sharded optimizers in a one-rank NCCL group
    with tempfile.TemporaryDirectory(prefix="moco_nccl_") as tmp:
        device = init_distributed("cuda", rank=0, world_size=1,
                                  init_method=f"file://{Path(tmp) / 'store'}")
        try:
            out["e"] = check_sharded_optimizers(process_group(), device, "phase13 (e)")
        finally:
            shutdown_distributed()
    print(f"phase13: {smi}", flush=True)
    return out


PHASE14_REPLICAS = 2
PHASE14_KILL_AT = 200        # (b): replica 0 dies at its 200th admitted request (chaos)
PHASE14_QUERIES = 64         # (d): /v1/knn queries through the router and to the full index
PHASE14_PARTIAL = 8          # (d): queries with one shard's replica SIGKILLed
PHASE14_LIMIT_S = 420.0      # the phase's own limit, its cold starts included
PHASE14_WAIT_S = 300.0       # one replica's launch to healthy: the fleet's startup grace
PHASE14_SIZE = 224           # the replicas' image size (phase 13's export)


def _load_client(spec_path: str) -> None:
    """`chip_smoke.py --load-client SPEC`: closed-loop clients in a process of
    their own, so the router's numbers are not the clients'. SPEC (JSON):
    "targets" [[url, clients], ...], "bodies" (a JSON list of request bodies),
    "total" (requests over all targets; null: until "stop_file" exists), "out"
    (an .npz: per request target, client, t0, t1 (wall clock), HTTP status
    (-1: no answer), pool index, and the embedding rows)."""
    import http.client
    import threading
    import urllib.parse

    import numpy as np

    with open(spec_path) as f:
        spec = json.load(f)
    with open(spec["bodies"]) as f:
        bodies = [b.encode() for b in json.load(f)]
    total, stop_file = spec.get("total"), spec.get("stop_file")
    end = time.monotonic() + spec.get("max_s", PHASE14_LIMIT_S)
    parent = os.getppid()
    n_clients = sum(c for _, c in spec["targets"])
    lock = threading.Lock()
    sent = [0]
    records, rows, errors = [], [], []

    def client(target: int, url: str, c: int, first: int) -> None:
        host, port = urllib.parse.urlsplit(url).netloc.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        i = first
        while True:
            with lock:
                if total is not None and sent[0] >= total:
                    break
                sent[0] += 1
            if (stop_file and os.path.exists(stop_file)) or time.monotonic() > end \
                    or os.getppid() != parent:
                break  # stopped, past the phase's limit, or orphaned
            k = i % len(bodies)
            i += n_clients
            t0 = time.time()
            try:
                conn.request("POST", "/v1/embed", body=bodies[k],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                status, data = resp.status, resp.read()
            except (OSError, http.client.HTTPException) as e:
                status, data = -1, repr(e).encode()
                conn.close()
                conn = http.client.HTTPConnection(host, int(port), timeout=120)
            t1 = time.time()
            row = None
            if status == 200:
                row = np.asarray(json.loads(data)["embedding"], np.float32)
            with lock:
                records.append((target, c, t0, t1, status, k))
                rows.append(row)
                if status != 200:
                    errors.append(f"{url} {status}: {data[:200]!r}")
        conn.close()

    threads, first = [], 0
    for target, (url, clients) in enumerate(spec["targets"]):
        for c in range(clients):
            threads.append(threading.Thread(target=client, args=(target, url, first, first)))
            first += 1
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dim = next((len(r) for r in rows if r is not None), 1)
    emb = np.stack([r if r is not None else np.zeros(dim, np.float32) for r in rows]) \
        if rows else np.zeros((0, dim), np.float32)
    np.savez(spec["out"], meta=np.asarray(records, np.float64).reshape(-1, 6), rows=emb,
             errors=np.asarray(errors[:50] or [""]))


class _Load:
    """One `--load-client` process; `result()` waits for it and reads its
    records back as (meta [n, 6], rows [n, D], errors)."""

    def __init__(self, tmp: Path, name: str, bodies_path: Path, targets: list, procs: list,
                 total: int | None = None):
        self.out = tmp / f"{name}.npz"
        self.stop_file = tmp / f"{name}.stop"
        spec = tmp / f"{name}.json"
        spec.write_text(json.dumps({"targets": targets, "bodies": str(bodies_path),
                                    "total": total, "stop_file": str(self.stop_file),
                                    "out": str(self.out)}))
        self.t0 = time.time()
        self.proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                      "--load-client", str(spec)], start_new_session=True)
        procs.append(self.proc)  # killed with the phase's other processes if it fails

    def stop(self) -> None:
        self.stop_file.write_text("")

    def result(self, timeout: float = 600.0):
        import numpy as np

        if self.proc.wait(timeout=timeout) != 0:
            fail(f"phase14: the load process exited {self.proc.returncode}", 1)
        self.wall = time.time() - self.t0
        data = np.load(self.out)
        return data["meta"], data["rows"], [e for e in data["errors"].tolist() if e]


def _http_json(url: str, body: dict | None = None, timeout: float = 30.0):
    """(status, JSON answer) of a GET, or of a POST of `body`."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _fleet_events(tel: Path) -> list[dict]:
    try:
        with open(tel / "events.jsonl") as f:
            return [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        return []


def _until(cond, timeout: float, what: str, deadline: float):
    """Poll `cond` every 50 ms until it answers truthy; fail past `timeout`
    or past the phase's deadline."""
    end = min(time.monotonic() + timeout, deadline)
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > end:
            fail(f"phase14: timed out waiting for {what}", 1)
        time.sleep(0.05)


def _prometheus_ok(text: str) -> dict:
    """The exposition is well formed (HELP/TYPE before samples, every sample
    line `name{labels} value`); returns {metric: samples}."""
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"'
                        r'(,[a-zA-Z0-9_]+="[^"]*")*\})? -?[0-9.e+-]+$')
    typed, metrics = set(), {}
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            parts = line.split(None, 3)
            if len(parts) < 4 or (parts[1] == "TYPE" and parts[3] not in ("gauge", "counter")):
                fail(f"phase14 (e): bad exposition line {line!r}", 1)
            if parts[1] == "TYPE":
                typed.add(parts[2])
        elif line:
            name = line.split("{", 1)[0].split(" ", 1)[0]
            if not sample.match(line) or name not in typed:
                fail(f"phase14 (e): bad exposition line {line!r}", 1)
            metrics[name] = metrics.get(name, 0) + 1
    if not text.endswith("\n"):
        fail("phase14 (e): the exposition does not end with a newline", 1)
    return metrics


def _replica_cmd(export: str, *extra: str) -> list[str]:
    """One port replica serving `export` on card 0 (ResNet-50, 224 px, the
    bucket ladder of phase 13, the cache off)."""
    return [sys.executable, "-m", "moco_tpu_torch.serve", "--pretrained", export,
            "--arch", "resnet50", "--image-size", "224",
            "--buckets", *[str(b) for b in PHASE13_BUCKETS], "--embed-cache-mb", "0", *extra]


class _GpuMemory:
    """Samples, every 0.5 s, each process's device memory as `nvidia-smi
    --query-compute-apps` lists it and the card's used memory
    (`torch.cuda.mem_get_info`); keeps the peaks."""

    def __init__(self):
        import threading

        import torch

        free, total = torch.cuda.mem_get_info()
        self.base = total - free
        self.card_peak = self.base
        self.per_pid: dict[int, float] = {}
        self.listed = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import torch

        while not self._stop.wait(0.5):
            free, total = torch.cuda.mem_get_info()
            self.card_peak = max(self.card_peak, total - free)
            try:
                out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                                      "--format=csv,noheader,nounits"], capture_output=True,
                                     text=True, timeout=10).stdout
            except (OSError, subprocess.SubprocessError):
                continue
            for line in out.splitlines():
                try:
                    pid, mib = (int(v) for v in line.split(","))
                except ValueError:
                    continue
                self.listed = self.listed or mib > 0  # a sandbox may list 0 for each
                self.per_pid[pid] = max(self.per_pid.get(pid, 0), mib)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=15)

    def describe(self, pids: list[int]) -> str:
        """The peaks so far, with `pids` the replicas alive since the launch."""
        share = (self.card_peak - self.base) / len(pids) / 2**30
        card = f"card used {self.base / 2**30:.2f} GiB before the launch, peak " \
               f"{self.card_peak / 2**30:.2f} GiB with {len(pids)} replicas ({share:.2f} GiB " \
               "a replica, card-wide)"
        if not self.listed:
            return f"{card}; nvidia-smi reports no per-process memory here"
        mine = ", ".join(f"pid {p} {self.per_pid.get(p, 0) / 1024:.2f} GiB" for p in pids)
        return f"{card}; per-replica peak (nvidia-smi) {mine}"


def _stop_proc(proc, label: str, timeout: float = 120.0, expect_zero: bool = True) -> float:
    """SIGTERM and wait; returns the drain's seconds. A process that does not
    exit in time is killed with its process group, and the phase fails."""
    import signal

    if proc.poll() is not None:
        fail(f"phase14: {label} exited {proc.returncode} before its stop", 1)
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        fail(f"phase14: {label} did not drain in {timeout:.0f} s", 1)
    if expect_zero and rc != 0:
        fail(f"phase14: {label} exited {rc} after SIGTERM, not 0", 1)
    return time.perf_counter() - t0


def _kill_group(proc) -> None:
    import signal

    if proc is not None and proc.poll() is None:
        with contextlib.suppress(OSError):
            os.killpg(proc.pid, signal.SIGKILL)
        with contextlib.suppress(subprocess.TimeoutExpired):
            proc.wait(timeout=30)


def run_fleet(counters: dict, smi: str, workdir=None) -> dict:
    """Phase 14, the replicated fleet of port replicas and obsd on one card:
    `python -m moco_tpu_torch.serve_fleet --replicas 2` over two `python -m
    moco_tpu_torch.serve` replicas of phase 13's ResNet-50 export (its own,
    made here, when the phase runs alone), with `python -m
    moco_tpu_torch.obsd` tailing the fleet's telemetry directory, and every
    load from PHASE13_CLIENTS closed-loop clients in a `--load-client`
    process of its own. (b) first: replica 0 is SIGKILLed by its chaos
    (`kill_at_request`) under PHASE13_REQUESTS requests: nothing lost, the
    death's class, death-to-healthy seconds, the router's retries. (a) then
    the same load on the whole fleet: requests/s, p50/p99, 0 errors, each
    answer against one replica's row of the same image within phase 13's
    cross-bucket tolerance; each replica's launch-to-healthy seconds and
    device memory. (c) the reload roll under load: a second export with its
    manifest and a truncated third step in the watch directory; the third is
    quarantined, the roll's seconds, the router's healthy count never below
    N-1, no request dropped, each answer the old or the new row, every
    answer sent after the roll the new one, and one client held on each
    replica seeing old rows, then new ones. (e) obsd's /metrics, /runs and
    /slo on that fleet, then the fleet's and obsd's drains (exit 0), and
    obsd's only writes its own slo lines. (d) phase 13's bank and IVF index
    behind `--ann-shards 2`: /v1/knn through the router against a lone
    full-index replica on PHASE14_QUERIES queries, then `partial: true`
    with one shard's replica SIGKILLed. The autoscaler is not driven here
    (the CPU tests hold it). None of the eight kernels launches."""
    import base64
    import signal
    import threading

    import numpy as np
    import torch

    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.resilience.chaos import truncate_checkpoint
    from moco_tpu_torch.resilience.integrity import manifest_path, write_manifest
    from moco_tpu_torch.serve import EmbeddingEngine
    from moco_tpu_torch.serve.fleet import pick_free_port

    for fn in counters.values():
        fn.launches = 0
    t_phase = time.monotonic()
    deadline = t_phase + PHASE14_LIMIT_S
    out: dict = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs: list = []
    with _serving_dir(workdir, "moco_phase14_") as shared, \
            _serving_dir(None, "moco_phase14_run_") as tmp:
        exports = _serving_exports(shared)
        bank_path = shared / "bank" / "2" / "bank.npz"
        if not bank_path.is_file():
            engine = EmbeddingEngine.from_checkpoint(exports[1], "resnet50", image_size=224,
                                                     buckets=PHASE13_BUCKETS)
            engine.warmup()
            _serving_bank(shared, exports[1], engine, "phase14 (d)")
            del engine
            torch.cuda.empty_cache()
        pool = np.random.RandomState(13).randint(
            0, 256, (PHASE13_POOL, PHASE14_SIZE, PHASE14_SIZE, 3)).astype(np.uint8)
        bodies_path = tmp / "bodies.json"
        bodies_path.write_text(json.dumps([json.dumps(
            {"image_b64": base64.b64encode(im.tobytes()).decode("ascii"),
             "shape": list(im.shape)}) for im in pool]))
        tel, watch = tmp / "fleet", tmp / "watch"
        watch.mkdir()
        router = f"http://127.0.0.1:{pick_free_port()}"
        obsd_url = f"http://127.0.0.1:{pick_free_port()}"
        memory = _GpuMemory()
        try:
            obsd = subprocess.Popen(
                [sys.executable, "-m", "moco_tpu_torch.obsd", str(tel), "--port",
                 obsd_url.rsplit(":", 1)[1], "--tick-secs", "0.5"],
                cwd=ROOT, env=env, start_new_session=True, stdout=open(tmp / "obsd.log", "w"),
                stderr=subprocess.STDOUT)
            procs.append(obsd)
            t_launch = time.time()
            fleet = subprocess.Popen(
                [sys.executable, "-m", "moco_tpu_torch.serve_fleet", "--replicas",
                 str(PHASE14_REPLICAS), "--port", router.rsplit(":", 1)[1], "--telemetry-dir",
                 str(tel), "--watch-dir", str(watch), "--stats-every-secs", "2",
                 "--chaos", f"kill_at_request={PHASE14_KILL_AT}", "--chaos-replica", "0",
                 "--", *_replica_cmd(exports[0])],
                cwd=ROOT, env=env, start_new_session=True, stdout=open(tmp / "fleet.log", "w"),
                stderr=subprocess.STDOUT)
            procs.append(fleet)

            def healthy() -> int:
                try:
                    return _http_json(router + "/healthz", timeout=5)[1]["healthy"]
                except OSError:
                    if fleet.poll() is not None:
                        fail(f"phase14: the fleet exited {fleet.returncode}; its log:\n"
                             f"{(tmp / 'fleet.log').read_text()[-3000:]}", 1)
                    return -1

            _until(lambda: healthy() == PHASE14_REPLICAS, PHASE14_WAIT_S, "2 healthy replicas",
                   deadline)
            events = _fleet_events(tel)
            launch_t = {e["replica"]: e["t"] for e in events if e.get("event") == "launch"}
            up_t = {e["replica"]: e["t"] for e in events if e.get("event") == "replica_healthy"}
            boot = {r: up_t[r] - launch_t[r] for r in sorted(up_t)}
            run_id = events[0]["run_id"]
            stats = _http_json(router + "/stats")[1]
            pids = [r["pid"] for r in stats["replicas"]]
            ports = [r["port"] for r in stats["replicas"]]
            print(f"phase14 (a): fleet router {router}, {PHASE14_REPLICAS} replicas (pids {pids}) "
                  f"healthy {time.time() - t_launch:.2f} s after the launch; launch to healthy "
                  + ", ".join(f"replica {r} {s:.2f} s" for r, s in boot.items())
                  + f" (startup grace 300 s)", flush=True)
            # one replica's own row of each pool image, one request at a time
            ref = np.stack([np.asarray(_http_json(
                f"http://127.0.0.1:{ports[1]}/v1/embed", json.loads(b), timeout=120)[1]
                ["embedding"], np.float32) for b in json.loads(bodies_path.read_text())])
            scale = float(np.abs(ref).max())
            tol = PHASE13_ROW_RTOL * scale

            # (b) the kill drill: replica 0's chaos fires under this load
            load = _Load(tmp, "kill", bodies_path, [[router, PHASE13_CLIENTS]], procs,
                         total=PHASE13_REQUESTS)
            meta, rows, errors = load.result()
            lost = int((meta[:, 4] < 0).sum())
            ok = meta[:, 4] == 200
            if lost or len(meta) != PHASE13_REQUESTS:
                fail(f"phase14 (b): {len(meta)} answers, {lost} lost: {errors[:3]}", 1)
            events = _fleet_events(tel)
            exits = [e for e in events if e.get("event") == "replica_exit" and e["replica"] == 0]
            if not exits:
                fail("phase14 (b): the chaos never killed replica 0", 1)
            t_dead = exits[0]["t"]
            _until(lambda: [e for e in _fleet_events(tel) if e.get("event") == "replica_healthy"
                            and e["replica"] == 0 and e["t"] > t_dead], PHASE14_WAIT_S,
                   "replica 0 healthy again", deadline)
            back = [e for e in _fleet_events(tel) if e.get("event") == "replica_healthy"
                    and e["replica"] == 0 and e["t"] > t_dead][0]["t"]
            _until(lambda: healthy() == PHASE14_REPLICAS, PHASE14_WAIT_S, "2 healthy replicas",
                   deadline)
            counters_b = _http_json(router + "/stats")[1]["router"]
            err_b = float(np.abs(rows[ok] - ref[meta[ok, 5].astype(int)]).max())
            if err_b > tol:
                fail(f"phase14 (b): answers differ from the replica's rows by {err_b:.3e}", 1)
            out["b"] = dict(requests=len(meta), ok=int(ok.sum()), lost=lost,
                            classification=exits[0]["classification"],
                            death_to_healthy_s=back - t_dead, retries=counters_b["retries"],
                            retry_ok=counters_b["retry_ok"], row_err=err_b)
            print(f"phase14 (b): chaos kill_at_request={PHASE14_KILL_AT} on replica 0 under "
                  f"{PHASE13_CLIENTS} clients: {len(meta)} requests, {int(ok.sum())} answered "
                  f"200, {len(meta) - int(ok.sum())} structured, {lost} lost; the death "
                  f"classified {exits[0]['classification']!r} (returncode "
                  f"{exits[0]['returncode']}), healthy again {back - t_dead:.2f} s after it; "
                  f"router retries {counters_b['retries']} ({counters_b['retry_ok']} answered "
                  f"on the retry); answers within {err_b:.3e} of replica 1's rows", flush=True)

            # (a) the whole fleet under the same load
            before = _http_json(router + "/stats")[1]["router"]
            load = _Load(tmp, "steady", bodies_path, [[router, PHASE13_CLIENTS]], procs,
                         total=PHASE13_REQUESTS)
            meta, rows, errors = load.result()
            bad = int((meta[:, 4] != 200).sum())
            if bad or len(meta) != PHASE13_REQUESTS:
                fail(f"phase14 (a): {len(meta)} answers, {bad} not 200: {errors[:3]}", 1)
            err_a = float(np.abs(rows - ref[meta[:, 5].astype(int)]).max())
            if err_a > tol:
                fail(f"phase14 (a): answers differ from the replica's rows by {err_a:.3e} "
                     f"(tolerance {tol:.3e})", 1)
            lat = list(meta[:, 3] - meta[:, 2])
            wall = float(meta[:, 3].max() - meta[:, 2].min())
            after = _http_json(router + "/stats")[1]
            out["a"] = dict(boot_s=boot, rps=len(meta) / wall, p50_ms=_percentile_ms(lat, 50),
                            p99_ms=_percentile_ms(lat, 99), errors=bad, row_err=err_a,
                            retries=after["router"]["retries"] - before["retries"],
                            memory=memory.describe(pids))
            print(f"phase14 (a): {PHASE13_CLIENTS} clients in their own process through the "
                  f"router, {len(meta)} requests in {wall:.2f} s: {out['a']['rps']:.1f} "
                  f"requests/s, latency p50 {out['a']['p50_ms']:.1f} ms p99 "
                  f"{out['a']['p99_ms']:.1f} ms, {bad} errors, router retries "
                  f"{out['a']['retries']}; answers within {err_a:.3e} of one replica's row of "
                  f"the same image (tolerance {PHASE13_ROW_RTOL:g} x max |row| = {tol:.3e}); "
                  f"{out['a']['memory']}; host cores {os.cpu_count()}", flush=True)

            # (c) the reload roll under load
            stats = _http_json(router + "/stats")[1]
            ports = [r["port"] for r in stats["replicas"]]
            load = _Load(tmp, "roll", bodies_path,
                         [[router, PHASE13_CLIENTS]] + [[f"http://127.0.0.1:{p}", 1]
                                                        for p in ports], procs)
            seen_healthy = []
            watching = threading.Event()

            def watch_capacity():
                while not watching.is_set():
                    try:
                        seen_healthy.append(_http_json(router + "/healthz", timeout=5)[1]
                                            ["healthy"])
                    except OSError:
                        seen_healthy.append(-1)
                    time.sleep(0.05)

            capacity = threading.Thread(target=watch_capacity, daemon=True)
            capacity.start()
            time.sleep(PHASE13_RELOAD_LEAD_S)
            # each step is made whole (step 3 then torn) in a staging directory and
            # moved in, its manifest last, so the watcher never sees a step half
            # written or step 3 intact
            stage = tmp / "stage"
            for step in (2, 3):
                (stage / str(step)).mkdir(parents=True)
                (stage / str(step) / "encoder.npz").write_bytes(Path(exports[1]).read_bytes())
                write_manifest(str(stage), step)
            truncate_checkpoint(str(stage), 3)
            (watch / ".integrity").mkdir(exist_ok=True)
            for step in (2, 3):
                os.rename(stage / str(step), watch / str(step))
                os.rename(manifest_path(str(stage), step), manifest_path(str(watch), step))
            t_drop = time.time()

            def rolled():
                ev = _fleet_events(tel)
                done = [e for e in ev if e.get("event") == "reload_done" and e["step"] == 2]
                quarantined = [e for e in ev if e.get("event") == "reload_quarantine"
                               and e["step"] == 3]
                return (done[0], quarantined[0]) if done and quarantined else None

            done, quarantined = _until(rolled, 2 * 300.0, "the reload roll", deadline)
            time.sleep(PHASE13_RELOAD_LEAD_S)
            load.stop()
            meta, rows, errors = load.result()
            watching.set()
            capacity.join()
            ev = _fleet_events(tel)
            detected = [e for e in ev if e.get("event") == "reload_detected" and e["step"] == 2][0]
            swaps = [e for e in ev if e.get("event") == "reload_replica" and e.get("step") == 2]
            new = np.stack([np.asarray(_http_json(
                f"http://127.0.0.1:{ports[1]}/v1/embed", json.loads(b), timeout=120)[1]
                ["embedding"], np.float32) for b in json.loads(bodies_path.read_text())])
            if (meta[:, 4] != 200).any():
                fail(f"phase14 (c): {int((meta[:, 4] != 200).sum())} requests not answered "
                     f"200: {errors[:3]}", 1)
            k = meta[:, 5].astype(int)
            is_old = np.abs(rows - ref[k]).max(axis=1) <= tol
            is_new = np.abs(rows - new[k]).max(axis=1) <= tol
            if not (is_old | is_new).all():
                fail(f"phase14 (c): {int((~(is_old | is_new)).sum())} answers fit neither "
                     "engine", 1)
            gen = np.where(is_old, 0, 1)
            late_old = (meta[:, 2] > done["t"]) & (gen == 0)
            early_new = (meta[:, 3] < t_drop) & (gen == 1)
            if late_old.any() or early_new.any():
                fail(f"phase14 (c): {int(late_old.sum())} old rows sent after the roll "
                     f"ended, {int(early_new.sum())} new rows answered before the drop "
                     f"(targets {sorted(set(meta[late_old | early_new, 0].tolist()))}, first "
                     f"at {float(meta[late_old | early_new, 2].min()) - done['t']:.3f} s "
                     f"after the roll's end)", 1)
            per_replica = {}
            for target in (1, 2):
                sel = meta[:, 0] == target
                order = np.argsort(meta[sel, 2])
                g = gen[sel][order]
                if (np.diff(g) < 0).any() or g[0] != 0 or g[-1] != 1:
                    fail(f"phase14 (c): replica {target - 1}'s own client saw {g.tolist()}", 1)
                per_replica[target - 1] = float(meta[sel][order][int(np.argmax(g)), 2])
            routed = meta[:, 0] == 0
            flips = 0
            for c in np.unique(meta[routed, 1]):
                sel = routed & (meta[:, 1] == c)
                flips += int((np.diff(gen[sel][np.argsort(meta[sel, 2])]) < 0).any())
            min_healthy = min(h for h in seen_healthy if h >= 0)
            if min_healthy < PHASE14_REPLICAS - 1:
                fail(f"phase14 (c): the router's healthy count fell to {min_healthy}", 1)
            if not (watch / ".quarantine" / "3").is_dir():
                fail("phase14 (c): the truncated step 3 was not quarantined", 1)
            roll_s = done["t"] - detected["t"]
            out["c"] = dict(requests=len(meta), roll_s=roll_s, old=int((gen == 0).sum()),
                            new=int((gen == 1).sum()), min_healthy=min_healthy,
                            swap_t={e["replica"]: e["t"] - detected["t"] for e in swaps},
                            first_new_s={r: t - detected["t"] for r, t in per_replica.items()},
                            routed_clients_new_then_old=flips, quarantined=quarantined["step"])
            print(f"phase14 (c): steps 2 (a second export, manifested) and 3 (truncated) "
                  f"dropped into the watch directory under {PHASE13_CLIENTS} router clients "
                  f"and one client on each replica: step 3 quarantined "
                  f"({quarantined['reason']}), step 2 rolled in {roll_s:.2f} s (detected to "
                  f"done; replica swaps at "
                  + ", ".join(f"{e['replica']}: {e['t'] - detected['t']:.2f} s" for e in swaps)
                  + f"); {len(meta)} requests all 200, {out['c']['old']} old rows then "
                  f"{out['c']['new']} new, none after the roll old; each replica's own client "
                  f"saw old rows, then new ones (first new at "
                  + ", ".join(f"{r}: {t:.2f} s" for r, t in out["c"]["first_new_s"].items())
                  + f"); {flips} of {PHASE13_CLIENTS} router clients saw a new row before an "
                  f"old one (the replicas swap one at a time); router healthy count never "
                  f"below {min_healthy}; reload_timeout_s 300 per replica", flush=True)

            # (e) obsd on the fleet: live, then after the drain (a replica's
            # registry flushes its serve records every 50, and at its drain)
            _until(lambda: "moco_tpu_router_requests_total" in _obsd_text(obsd_url), 30.0,
                   "obsd's router series", deadline)
            live = _prometheus_ok(_obsd_text(obsd_url))
            slo = _http_json(obsd_url + "/slo")[1]
            states = {r["name"]: {run: v["state"] for run, v in r["runs"].items()}
                      for r in slo["rules"]}
            drain_fleet_s = _stop_proc(fleet, "the fleet")

            def fleet_run():
                runs = _http_json(obsd_url + "/runs")[1]
                mine = [r for r in runs["runs"] if r["run_id"] == run_id]
                srcs = {os.path.basename(s) for r in mine for s in r["srcs"]}
                ok = mine and {"fleet", "replica0", "replica1"} <= srcs \
                    and {"fleet", "serve"} <= set(mine[0]["kinds"])
                return (runs, mine[0], srcs) if ok else None

            runs, run, srcs = _until(fleet_run, 30.0, "obsd's fleet run with both replicas",
                                     deadline)
            _until(lambda: _http_json(obsd_url + "/runs")[1]["polls"] > runs["polls"] + 2, 30.0,
                   "obsd's last ticks", deadline)
            metrics_text = _obsd_text(obsd_url)
            series = _prometheus_ok(metrics_text)
            written = _http_json(obsd_url + "/runs")[1]["slo_written"]
            _stop_proc(obsd, "obsd")
            slo_lines, foreign = 0, []
            for path in tel.rglob("events.jsonl"):
                for ln in path.read_text().splitlines():
                    rec = json.loads(ln)
                    if rec.get("kind") == "slo":
                        slo_lines += 1
                        if rec.get("run_id") != run_id:
                            foreign.append(rec)
            if slo_lines != written or foreign:
                fail(f"phase14 (e): {slo_lines} slo lines in the streams, obsd wrote {written}; "
                     f"{foreign[:2]}", 1)
            out["e"] = dict(series=len(series), live_series=len(live), streams=runs["streams"],
                            kinds=run["kinds"], slo_states=states, slo_lines=slo_lines,
                            fleet_drain_s=drain_fleet_s)
            print(f"phase14 (e): obsd /metrics valid exposition live ({len(live)} series) and "
                  f"after the fleet's drain ({len(series)} series, {sum(series.values())} "
                  f"samples, router requests "
                  f"{_metric_value(metrics_text, 'moco_tpu_router_requests_total')}, serve "
                  f"latency {_metric_value(metrics_text, 'moco_tpu_serve_latency_ms')} ms); "
                  f"/runs {runs['streams']} streams, the fleet's run from {sorted(srcs)} with "
                  f"kinds {run['kinds']}; /slo states live {states}; obsd wrote {written} slo "
                  f"line(s) and nothing else; the fleet drained on SIGTERM in "
                  f"{drain_fleet_s:.2f} s (exit 0), obsd exit 0", flush=True)

            # (d) the ANN scatter-gather over two shards against a full-index replica
            flags = ["--knn-bank", str(bank_path), "--ann-cells", str(PHASE13_CELLS),
                     "--ann-nprobe", str(PHASE13_CELLS), "--num-classes", "10"]
            ann_tel = tmp / "ann_fleet"
            router2 = f"http://127.0.0.1:{pick_free_port()}"
            full_port = pick_free_port()
            fleet2 = subprocess.Popen(
                [sys.executable, "-m", "moco_tpu_torch.serve_fleet", "--replicas", "2",
                 "--ann-shards", "2", "--port", router2.rsplit(":", 1)[1], "--telemetry-dir",
                 str(ann_tel), "--", *_replica_cmd(exports[1], *flags)],
                cwd=ROOT, env=env, start_new_session=True,
                stdout=open(tmp / "fleet2.log", "w"), stderr=subprocess.STDOUT)
            procs.append(fleet2)
            full = subprocess.Popen(
                _replica_cmd(exports[1], *flags, "--port", str(full_port)), cwd=ROOT, env=env,
                start_new_session=True, stdout=open(tmp / "full.log", "w"),
                stderr=subprocess.STDOUT)
            procs.append(full)

            def up(url):
                try:
                    return _http_json(url + "/healthz", timeout=5)[0] == 200
                except OSError:
                    return False

            t0 = time.time()
            _until(lambda: up(router2) and _http_json(router2 + "/healthz")[1]["healthy"] == 2
                   and up(f"http://127.0.0.1:{full_port}"), PHASE14_WAIT_S,
                   "the sharded fleet and the full-index replica", deadline)
            boot2 = time.time() - t0
            queries = SyntheticDataset(num_samples=PHASE14_QUERIES, image_size=PHASE14_SIZE,
                                       seed=999)
            q_bodies = [{"image_b64": base64.b64encode(im.tobytes()).decode("ascii"),
                         "shape": list(im.shape)} for im in queries.images]
            fan, ref_cls = [], []
            for b in q_bodies:
                st, ans = _http_json(router2 + "/v1/knn", b, timeout=120)
                if st != 200 or ans.get("partial") or ans.get("shards_answered") != 2:
                    fail(f"phase14 (d): the fan-out answered {st} {ans}", 1)
                fan.append(ans["class"])
                st, ans = _http_json(f"http://127.0.0.1:{full_port}/v1/knn", b, timeout=120)
                if st != 200:
                    fail(f"phase14 (d): the full-index replica answered {st} {ans}", 1)
                ref_cls.append(ans["class"])
            agree = sum(a == b for a, b in zip(fan, ref_cls))
            if agree != len(fan):
                fail(f"phase14 (d): the fan-out agrees with the full index on {agree} of "
                     f"{len(fan)} queries", 1)
            victim = [r for r in _http_json(router2 + "/stats")[1]["replicas"]
                      if r["shard"] == 1][0]
            os.kill(victim["pid"], signal.SIGKILL)
            partial = []
            for b in q_bodies[:PHASE14_PARTIAL]:
                st, ans = _http_json(router2 + "/v1/knn", b, timeout=120)
                partial.append((st, ans.get("partial"), ans.get("shards_answered")))
            if any(p != (200, True, 1) for p in partial):
                fail(f"phase14 (d): with shard 1's replica killed the answers were {partial}", 1)
            fan_stats = _http_json(router2 + "/stats")[1]["router"]
            _stop_proc(fleet2, "the sharded fleet")
            _stop_proc(full, "the full-index replica")
            out["d"] = dict(queries=len(fan), agree=agree, partial=len(partial), boot_s=boot2,
                            knn_fanout=fan_stats["knn_fanout"],
                            knn_partial=fan_stats["knn_partial"])
            print(f"phase14 (d): --ann-shards 2 over phase 13's bank ({PHASE13_BANK} rows, "
                  f"{PHASE13_CELLS} cells, nprobe {PHASE13_CELLS}) and a lone full-index "
                  f"replica, healthy {boot2:.2f} s after their launch: /v1/knn through the "
                  f"router equals the full index on {agree} of {len(fan)} queries (each "
                  f"partial: false, 2 shards answered); with shard 1's replica SIGKILLed "
                  f"{len(partial)} of {len(partial)} answers 200 with partial: true (1 shard); "
                  f"router knn_fanout {fan_stats['knn_fanout']} knn_partial "
                  f"{fan_stats['knn_partial']}", flush=True)
        finally:
            memory.close()
            for p in procs:
                _kill_group(p)
    launched = {name: fn.launches for name, fn in counters.items() if fn.launches}
    if launched:
        fail(f"phase14: the serving path launched training kernels: {launched}", 1)
    out["seconds"] = time.monotonic() - t_phase
    print(f"phase14: {out['seconds']:.1f} s (limit {PHASE14_LIMIT_S:.0f} s); {smi}", flush=True)
    return out


PHASE15_BATCH = 128         # the one-card run: ViT-B/16, 224 px, bf16, remat, AdamW
PHASE15_STEPS = 3           # steps of each run
PHASE15_RANK_BATCH = 256    # --phase15 under torchrun: a card's share of the global batch
PHASE15_BYTES_RATIO = 0.27  # (a): a card's state bytes under fsdp (1 x 4) over dp's, at most
PHASE15_QUANT_RTOL = 0.05   # (c): |loss - dp's| <= rtol * max(|dp's|, 1), the JAX band
# the torchrun variables a child launch of its own must not inherit
TORCHRUN_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                "GROUP_WORLD_SIZE", "ROLE_RANK", "ROLE_NAME", "ROLE_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


def _phase15_config(batch: int, **overrides):
    """`imagenet-moco-v3-vitb` at full width on synthetic data at `batch`,
    without the warmup (its first steps would move the weights by a few
    ulps)."""
    from moco_tpu_torch.config import get_preset

    return get_preset("imagenet-moco-v3-vitb").replace(
        dataset="synthetic", batch_size=batch, staging_workers=4, prefetch_depth=2,
        print_freq=1, warmup_epochs=0, **overrides)


def _fsdp_train(config, label: str, counters: dict, dataset, steps: int, device) -> dict:
    """`_v3_train` of a v3 config (the blur's two launches a step counted
    and held against its plain version) with the fsdp plan's gathers timed
    by CUDA events, the memory allocated after each release (between
    steps; dp: after the run) and at the peak, both over what was allocated
    before the run, the gradient sync's bytes of each step and its
    `describe()`, and the state's bytes a card."""
    import torch

    from moco_tpu_torch.parallel import fsdp
    from moco_tpu_torch.parallel.gradsync import GradSync

    plan_cls = fsdp.ShardingPlan
    real_gather, real_release, real_finish = plan_cls.gather, plan_cls.release, GradSync.finish
    gathers, between, carried, described = [], [], [], []

    def gather(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real_gather(self)
        end.record()
        gathers.append((start, end))

    def release(self):
        real_release(self)
        between.append(torch.cuda.memory_allocated(device))

    def finish(self, state):
        real_finish(self, state)
        carried.append(self.last_bytes)
        if not described:
            described.append(self.describe(state.model_q.named_parameters()))

    base = torch.cuda.memory_allocated(device)  # what earlier runs still hold
    plan_cls.gather, plan_cls.release, GradSync.finish = gather, release, finish
    try:
        r = _v3_train(config, label, counters, dataset, steps, V3_VIT_PER_STEP, device=device)
    finally:
        plan_cls.gather, plan_cls.release, GradSync.finish = real_gather, real_release, \
            real_finish
    torch.cuda.synchronize()
    state = r["state"]
    r.update(gather_ms=[s.elapsed_time(e) for s, e in gathers[:steps]],
             between_gib=((between[steps - 1] if state.fsdp is not None
                           else torch.cuda.memory_allocated(device)) - base) / 2**30,
             peak_gib=r["max_memory_gib"] - base / 2**30,
             carried=carried, describe=described[0] if described else None,
             bytes=fsdp.state_bytes_per_device(state))
    if state.fsdp is not None and len(gathers) < steps:
        fail(f"{label}: {len(gathers)} gathers in {steps} steps", 1)
    return r


def _rank0() -> bool:
    """This process is rank 0 of its torchrun (or runs alone)."""
    return int(os.environ.get("RANK", 0)) == 0


def _fsdp_line(label: str, r: dict, smi: str) -> None:
    if not _rank0():
        return
    ms = r["gather_ms"]
    gather = (f", gather {sum(ms[1:]) / max(len(ms) - 1, 1):.2f} ms a step over steps "
              f"2-{len(ms)} ({', '.join(f'{v:.2f}' for v in ms)})" if ms else "")
    print(f"{label}: {r['imgs_per_s']:.1f} imgs/s over steps 2-{len(r['losses'])}, state "
          f"{r['bytes']['state_bytes_per_device'] / 2**20:.2f} MiB a card (params "
          f"{r['bytes']['param_bytes_per_device'] / 2**20:.2f}, optimizer "
          f"{r['bytes']['opt_bytes_per_device'] / 2**20:.2f}), allocated between steps "
          f"{r['between_gib']:.3f} GiB, peak {r['peak_gib']:.3f} GiB (over what was held "
          f"before){gather}, losses "
          f"{r['losses']} ({smi})", flush=True)


def _fsdp_equal(a: dict, b: dict, label: str) -> None:
    """Fail unless two runs are equal bit for bit: losses, both models, the
    optimizer's full state (a collective under fsdp), the generators."""
    diff = _v3_states_differ(a["state"], b["state"])
    if a["losses"] != b["losses"]:
        diff.append(f"losses {a['losses']} != {b['losses']}")
    if diff:
        fail(f"{label}: the runs differ in {diff[:6]}", 1)
    if _rank0():
            print(f"{label}: equal bit for bit: {len(a['losses'])} losses, both encoders, "
              "AdamW's moments and steps, the generators", flush=True)


def _fsdp_legs(counters: dict, dataset, smi: str, batch: int, device, group,
               ckpt_dir=None) -> dict:
    """Phase 15's runs in the group: dp, then fsdp, each PHASE15_STEPS
    steps of ViT-B/16 at `batch`, bit for bit; on more than one rank also
    (b) fsdp_tp, (c) fsdp_tp with quantized int8 (the two-hop reduce) and,
    with `ckpt_dir`, (d)'s fsdp run with quantized int8 that checkpoints
    its last step."""
    import torch

    from moco_tpu_torch.parallel.mesh import world_size

    n = world_size(group)
    data = _Repeat(dataset, batch * (PHASE15_STEPS + 1))
    out = {}
    runs = {}
    for name, kw in (("dp", {}), ("fsdp", dict(sharding="fsdp"))):
        runs[name] = _fsdp_train(_phase15_config(batch, **kw), f"phase15 {name} {n} card(s)",
                                 counters, data, PHASE15_STEPS, device)
        _fsdp_line(f"phase15 {name} {n} card(s)", runs[name], smi)
    _fsdp_equal(runs["fsdp"], runs["dp"], f"phase15 fsdp vs dp {n} card(s)")
    ratio = (runs["fsdp"]["bytes"]["state_bytes_per_device"]
             / runs["dp"]["bytes"]["state_bytes_per_device"])
    if n > 1 and ratio > PHASE15_BYTES_RATIO:
        fail(f"phase15: fsdp holds {ratio:.3f} of dp's state bytes a card, above "
             f"{PHASE15_BYTES_RATIO}", 1)
    for name, r in runs.items():
        out[name] = {k: r[k] for k in ("losses", "imgs_per_s", "peak_gib", "between_gib",
                                       "gather_ms", "bytes", "blur")}
    out["state_bytes_ratio"] = ratio
    if _rank0():
        print(f"phase15 fsdp/dp state bytes a card: {ratio:.4f} ({smi})", flush=True)
    if n == 1:
        return out
    dp = runs.pop("dp")
    del runs
    tp = _fsdp_train(_phase15_config(batch, sharding="fsdp_tp"), f"phase15 fsdp_tp {n} cards",
                     counters, data, PHASE15_STEPS, device)
    _fsdp_line(f"phase15 fsdp_tp {n} cards", tp, smi)
    _fsdp_equal(tp, dp, f"phase15 fsdp_tp vs dp {n} cards")
    out["fsdp_tp"] = {k: tp[k] for k in ("losses", "imgs_per_s", "peak_gib", "between_gib",
                                         "gather_ms", "bytes")}
    del tp
    q = _fsdp_train(_phase15_config(batch, sharding="fsdp_tp", grad_sync="quantized"),
                    f"phase15 fsdp_tp quantized {n} cards", counters, data, PHASE15_STEPS,
                    device)
    _fsdp_line(f"phase15 fsdp_tp quantized {n} cards", q, smi)
    far = [(a, b) for a, b in zip(q["losses"], dp["losses"])
           if abs(a - b) > PHASE15_QUANT_RTOL * max(abs(b), 1.0)]
    if far:
        fail(f"phase15: the two-hop quantized losses leave the JAX band of dp's: {far}", 1)
    acc = max(float(v.abs().max()) for v in q["state"].gradsync.values())
    hops = q["describe"].get("multihop")
    if hops is None or not acc:
        fail(f"phase15: fsdp_tp quantized ran no two-hop reduce (describe {q['describe']}, "
             f"largest accumulator {acc})", 1)
    if _rank0():
        print(f"phase15 two-hop: intra (fsdp {hops['intra_size']}) {hops['intra_bytes_per_step']} "
              f"B a step, inter (data {hops['inter_size']}) {hops['inter_bytes_per_step']} B, "
              f"analytic {q['describe']['sync_bytes_per_step']} B, carried "
              f"{q['describe']['carried_bytes_per_step']} B, carried in each step "
              f"{q['carried']}; losses {q['losses']} against dp's {dp['losses']}, largest "
              f"accumulator {acc:.4g} ({smi})", flush=True)
    out["fsdp_tp_quantized"] = dict(losses=q["losses"], describe=q["describe"],
                                    carried=q["carried"], max_acc=acc)
    del q
    if ckpt_dir is not None:
        d = _fsdp_train(_phase15_config(batch, sharding="fsdp", grad_sync="quantized",
                                        ckpt_dir=str(ckpt_dir), steps_per_epoch=PHASE15_STEPS),
                        f"phase15 fsdp quantized {n} cards, checkpointed", counters, data,
                        PHASE15_STEPS, device)
        out["checkpoint"] = dict(step=d["state"].step, losses=d["losses"], max_acc=max(
            float(v.abs().max()) for v in d["state"].gradsync.values()))
        del d
    torch.cuda.empty_cache()
    return out


def run_fsdp(counters: dict, dataset, smi: str) -> dict:
    """Phase 15 on one card: dp and fsdp (`imagenet-moco-v3-vitb`) in a
    one-rank NCCL group, under deterministic cuDNN."""
    import tempfile

    import torch

    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, \
        shutdown_distributed

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="moco_nccl_") as tmp:
            device = init_distributed("cuda", rank=0, world_size=1,
                                      init_method=f"file://{Path(tmp) / 'store'}")
            try:
                return _fsdp_legs(counters, dataset, smi, PHASE15_BATCH, device,
                                  process_group())
            finally:
                shutdown_distributed()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def fsdp_across_cards(counters: dict, dataset, smi: str) -> dict:
    """`--phase15` under torchrun: (a)-(c) over every card, (d)'s
    checkpoint, then (d) itself: rank 0 launches `--phase15d` under a
    two-process torchrun on cards 0 and 1 once the group has ended."""
    import tempfile

    import torch

    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, \
        shutdown_distributed

    import shutil

    import torch.distributed as dist

    torch.backends.cudnn.deterministic = True
    is_main = _rank0()
    device = init_distributed("cuda")
    group = process_group()
    try:
        # rank 0's directory, for every rank
        names = [None] * dist.get_world_size(group)
        dist.all_gather_object(names, tempfile.mkdtemp(prefix="moco_phase15_") if is_main
                               else None, group=group)
        ckpt_dir = Path(names[0])
        out = _fsdp_legs(counters, dataset, smi, PHASE15_RANK_BATCH * len(names), device,
                         group, ckpt_dir=ckpt_dir)
    finally:
        shutdown_distributed()
    if not is_main:
        return out
    env = {k: v for k, v in os.environ.items()
           if k not in TORCHRUN_ENV and not k.startswith("TORCHELASTIC_")}
    env["CUDA_VISIBLE_DEVICES"] = "0,1"
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", str(ROOT / "chip_smoke.py"), "--phase15d",
                           str(ckpt_dir)], env=env, capture_output=True, text=True,
                          timeout=600)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(proc.stdout[-6000:], proc.stderr[-4000:], sep="\n", flush=True)
    if proc.returncode:
        fail(f"phase15 (d): the two-rank restore exited {proc.returncode}", 1)
    out["restore_2_ranks"] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


def fsdp_restore_check(ckpt_dir: Path) -> dict:
    """`--phase15d DIR` under a two-process torchrun: (d), the four-rank
    fsdp checkpoint of `DIR` restored by a two-rank fsdp run through
    `train.train` (no step taken): both encoders bit for bit with the saved
    ones, the accumulators zero, the `ckpt-dialect` event of the world-size
    change logged."""
    import torch

    from moco_tpu_torch import train
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, rank, \
        shutdown_distributed, world_size
    from moco_tpu_torch.utils import logging as mlog

    events = []
    device = init_distributed("cuda")
    try:
        group = process_group()
        payload = torch.load(ckpt_dir / str(PHASE15_STEPS) / "state.pt", map_location="cpu",
                             weights_only=True)
        batch = PHASE15_RANK_BATCH * 4
        config = _phase15_config(batch, sharding="fsdp", grad_sync="quantized",
                                 ckpt_dir=str(ckpt_dir), resume="auto",
                                 steps_per_epoch=PHASE15_STEPS)

        def sink(kind, msg, fields):
            events.append((kind, msg))

        mlog.add_event_sink(sink)
        try:
            state, _ = train.train(config, max_steps=PHASE15_STEPS, device=device,
                                   dataset=_Repeat(SyntheticDataset(64, image_size=224),
                                                   (PHASE15_STEPS + 1) * batch))
        finally:
            mlog.remove_event_sink(sink)
        diff = [f"{name}.{k}" for name in ("model_q", "model_k")
                for k, v in getattr(state, name).state_dict().items()
                if not torch.equal(v.cpu(), payload[name][k])]
        acc = max(float(v.abs().max()) for v in state.gradsync.values())
        saved_acc = max(float(v.abs().max()) for v in payload["gradsync"]["acc"].values())
        dialect = [m for k, m in events if k == "ckpt-dialect"]
        # the event is rank 0's to log
        if diff or acc or not saved_acc or state.step != PHASE15_STEPS or (
                rank(group) == 0 and not dialect):
            fail(f"phase15 (d): the 2-rank restore differs in {diff[:6]}, largest accumulator "
                 f"{acc} (saved {saved_acc}), step {state.step}, ckpt-dialect events "
                 f"{dialect}", 1)
        return dict(ranks=world_size(group), step=state.step, saved_max_acc=saved_acc,
                    event=dialect[0] if dialect else None,
                    shard_bytes=state.fsdp is not None and sum(
                        t.numel() * t.element_size() for t in state.fsdp.shards.values()))
    finally:
        shutdown_distributed()


# phase 16: config 1 (`cifar10-moco-v1`: ResNet-18 with the CIFAR stem, 32 px,
# K=4096, f32) from a written `cifar-10-batches-py` tree of 5 x 512 train and
# 512 test images (10 steps an epoch at batch 256)
PHASE16_PER_BATCH = 512
PHASE16_TEST = 512
PHASE16_EPOCHS = 3
PHASE16_STEPS = 4           # the in-process run whose peak memory is read
# [N*H*W, C] of every ResNet-18 BN with the CIFAR stem at batch 256, 32 px,
# and how many BNs of that shape one encoder has (20 in all)
R18_BN_SHAPES = {
    "s1_64": ((BATCH * 32 * 32, 64), 5), "s2_128": ((BATCH * 16 * 16, 128), 5),
    "s3_256": ((BATCH * 8 * 8, 256), 5), "s4_512": ((BATCH * 4 * 4, 512), 5),
}


def _cli(argv: list[str], label: str, timeout: float = 600) -> str:
    """Run `python -m <argv>` from the checkout; its output lands in
    chiprun_out/phase16_<label>.log. Fails unless it exits 0."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], env=env, capture_output=True,
                          text=True, timeout=timeout, cwd=str(ROOT))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"phase16_{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"phase16 {label}: exit {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-2000:]}", 1)
    print(f"phase16 {label}: exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return proc.stdout


def run_config1(counters: dict, stats, smi: str) -> dict:
    """Phase 16: config 1 on the card. (a) a `cifar-10-batches-py` tree
    written from a seed; (b) `python -m moco_tpu_torch.train --preset
    cifar10-moco-v1 --data-dir <tree>` for PHASE16_EPOCHS epochs with its
    kNN monitor (the untrained row first, finite losses, the queue pointer
    256 ahead a step, imgs/s), then the same config in this process for the
    peak memory; (c) the BN pair at the four ResNet-18@32 shapes in f32 and
    bf16 against its plain version, timed, and one profiled step
    (`profile_step`) whose launches must equal the count worked out from
    the encoder's BNs; (d) the probe for an epoch with a checkpoint,
    `--evaluate` after a resume (`sanity_check` against the file), and,
    in a process beside theirs, kNN, on (b)'s export."""
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from moco_tpu_torch import train
    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.data.datasets import CIFAR10, write_cifar10_tree
    from moco_tpu_torch.models.fast_bn import FastBatchNorm

    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="moco_cifar_") as tmp:
        tmp = Path(tmp)
        # (a)
        t0 = time.perf_counter()
        tree = write_cifar10_tree(str(tmp / "data"), per_batch=PHASE16_PER_BATCH,
                                  test_size=PHASE16_TEST, seed=0)
        size = sum(f.stat().st_size for f in Path(tree).iterdir())
        data = CIFAR10(str(tmp / "data"))
        if len(data) != 5 * PHASE16_PER_BATCH or data.images.shape[1:] != (32, 32, 3):
            fail(f"phase16 (a): the tree reads back {len(data)} images", 1)
        print(f"phase16 (a): cifar-10-batches-py with 5 x {PHASE16_PER_BATCH} train and "
              f"{PHASE16_TEST} test images, {size} bytes, written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        # (b) through the CLI
        config = get_preset("cifar10-moco-v1").replace(data_dir=str(tmp / "data"),
                                                       print_freq=1)
        enc = tmp / "enc.npz"
        text = _cli(["moco_tpu_torch.train", "--preset", "cifar10-moco-v1", "--data-dir",
                     str(tmp / "data"), "--epochs", str(PHASE16_EPOCHS), "--print-freq", "1",
                     "--export-path", str(enc)], "train")
        lines = text.splitlines()
        steps = [(int(m[1]), float(m[2]), int(float(m[3])), float(m[4])) for m in (
            re.match(r"^step (\d+) loss (\S+) .* queue_ptr (\S+) step_s (\S+) ", ln)
            for ln in lines) if m]
        knn = [ln for ln in lines if "kNN(" in ln]
        spe = 5 * PHASE16_PER_BATCH // BATCH
        total = PHASE16_EPOCHS * spe
        if len(steps) != total or [s[0] for s in steps] != list(range(1, total + 1)):
            fail(f"phase16 (b): {len(steps)} step lines, expected {total}", 1)
        if not knn or not knn[0].startswith("Epoch [-1] kNN(val)") or \
                lines.index(knn[0]) > next(i for i, ln in enumerate(lines)
                                           if ln.startswith("step ")):
            fail(f"phase16 (b): the untrained kNN row does not come first: {knn[:2]}", 1)
        if not all(math.isfinite(s[1]) for s in steps):
            fail(f"phase16 (b): non-finite losses {[s[1] for s in steps]}", 1)
        ptrs = [s[2] for s in steps]
        if ptrs != [BATCH * n % config.num_negatives for n in range(1, total + 1)]:
            fail(f"phase16 (b): queue pointers {ptrs}", 1)
        if not enc.is_file():
            fail("phase16 (b): no export", 1)
        # steady: every step but each epoch's first (its loader stages from cold)
        steady = [s[3] for s in steps if (s[0] - 1) % spe]
        cli_rate = BATCH * len(steady) / sum(steady)
        print(f"phase16 (b): cifar10-moco-v1 (ResNet-18 CIFAR stem, 32 px, f32, K=4096, "
              f"B={BATCH}) through the CLI, {total} steps, losses {steps[0][1]:.4f} -> "
              f"{steps[-1][1]:.4f}, queue pointer {ptrs[-1]} after {total} steps, kNN rows "
              f"{len(knn)} ({knn[0]}; last: {knn[-1]}), {cli_rate:.1f} imgs/s steady (host "
              f"clock, metrics on the host every step) ({smi})", flush=True)
        # (b) in this process: the peak memory
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        state, history = train.train(config, max_steps=PHASE16_STEPS, device="cuda",
                                     on_step=lambda step, m, sec: times.append(sec))
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        bns = sum(isinstance(m, FastBatchNorm) for m in state.model_q.modules())
        rate = BATCH * (len(times) - 1) / sum(times[1:])
        print(f"phase16 (b) in process: {PHASE16_STEPS} steps, {bns} BNs an encoder, "
              f"{rate:.1f} imgs/s over steps 2-{PHASE16_STEPS}, peak memory {peak:.3f} GiB "
              f"over the {held / 2**30:.3f} held before ({smi})", flush=True)
        out["train"] = dict(cli_imgs_per_s=cli_rate, imgs_per_s=rate, peak_gib=peak,
                            losses=[s[1] for s in steps], bns=bns, knn=knn)
        # (c) the BN pair at the ResNet-18@32 shapes, and one profiled step
        # whose launches must be the count worked out from the encoder's BNs
        if sum(n for _, n in R18_BN_SHAPES.values()) != bns:
            fail(f"phase16 (c): the shape table holds other BNs than the encoder's {bns}", 1)
        out["kernels"] = {dt: check_stats_kernels(stats, R18_BN_SHAPES, dt, "phase16 (c)")
                          for dt in ("float32", "bfloat16")}
        per_step = {name: 0 for name in counters}
        per_step.update(channel_sums=BN_LAUNCHES["channel_sums"] * bns,
                        channel_grad_sums=BN_LAUNCHES["channel_grad_sums"] * bns)
        busy_ms, wall_ms = profile_step(config, state, data, "config1", counters, per_step)
        out["profile"] = dict(launches=per_step, busy_ms=busy_ms, wall_ms=wall_ms)
        print(f"phase16 (c): one profiled config-1 step launched channel_sums "
              f"{per_step['channel_sums']} and channel_grad_sums "
              f"{per_step['channel_grad_sums']} times (2 and 1 a BN, {bns} BNs), device "
              f"busy {busy_ms:.2f} of {wall_ms:.2f} ms", flush=True)
        del state, history
        torch.cuda.empty_cache()
        # (d) the journey on (b)'s export
        common = ["--pretrained", str(enc), "--arch", "resnet18", "--cifar-stem", "true",
                  "--dataset", "cifar10", "--data-dir", str(tmp / "data"), "--image-size",
                  "32", "--num-classes", "10"]
        probe = common + ["--batch-size", str(BATCH), "--epochs", "1", "--ckpt-dir",
                          str(tmp / "probe")]
        # kNN needs nothing of the probe: its process runs beside the probe's
        with ThreadPoolExecutor(1) as pool:
            knn_run = pool.submit(_cli, ["moco_tpu_torch.evals.knn", *common], "knn")
            text = _cli(["moco_tpu_torch.evals.lincls", *probe], "lincls")
            acc = re.search(r"best val Acc@1: (\S+)", text)
            again = _cli(["moco_tpu_torch.evals.lincls", *probe, "--resume", "auto",
                          "--evaluate", "true"], "lincls_evaluate")
            ev = re.search(r"Evaluate: val Acc@1 (\S+)", again)
            knn_text = knn_run.result()
        top1 = re.search(r"kNN top-1: (\S+)%", knn_text)
        if not (acc and ev and top1):
            fail("phase16 (d): a CLI printed no accuracy", 1)
        if abs(float(ev[1]) - float(acc[1])) > 1e-6:
            fail(f"phase16 (d): --evaluate after the resume gave {ev[1]}, the epoch "
                 f"{acc[1]}", 1)
        out["evals"] = dict(lincls_acc1=float(acc[1]), evaluate_acc1=float(ev[1]),
                            knn_top1=float(top1[1]))
        print(f"phase16 (d): the probe 1 epoch val Acc@1 {acc[1]} (sanity_check passed), "
              f"--evaluate after the resume {ev[1]}, kNN top-1 {top1[1]}% ({smi})",
              flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase16: {out['seconds']:.1f} s", flush=True)
    return out


def _obsd_text(url: str) -> str:
    import urllib.request

    try:
        with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
            return resp.read().decode("utf-8")
    except OSError:
        return ""


def _metric_value(text: str, name: str) -> str:
    return next((ln.rsplit(" ", 1)[1] for ln in text.splitlines() if ln.startswith(name)),
                "absent")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not (ROOT / "moco_tpu_torch" / "__init__.py").is_file():
        fail(f"no moco_tpu_torch package next to {Path(__file__).name}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from moco_tpu_torch.utils.device import set_precision_policy

    # the package's f32 policy (TF32 off), as every entry point sets it: the
    # kernels' f32 checks below run before any entry point
    set_precision_policy()
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("set_precision_policy left TF32 on", 1)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}", flush=True)

    from moco_tpu_torch.ops import _build, blur, fused_conv, fused_conv3x3, stats

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s\n{log}", flush=True)
    counters = {"channel_sums": stats.channel_sums,
                "channel_grad_sums": stats.channel_grad_sums,
                "gaussian_blur_batch": blur.gaussian_blur_batch,
                "bn_relu_matmul": fused_conv.bn_relu_matmul,
                "bn_relu_matmul_dw": fused_conv.bn_relu_matmul_dw,
                "bn_relu_conv3x3": fused_conv3x3.bn_relu_conv3x3,
                "bn_relu_conv3x3_s2": fused_conv3x3.bn_relu_conv3x3_s2,
                "conv3x3_dw": fused_conv3x3.conv3x3_dw}
    from moco_tpu_torch.data.datasets import SyntheticDataset

    if "--phase8" in sys.argv[1:]:
        # phase 8 alone: under `torchrun --nproc-per-node <cards> chip_smoke.py
        # --phase8` (a) across every card, else the whole phase on one
        dataset = SyntheticDataset(num_samples=STEPS * BATCH, image_size=224)
        if "WORLD_SIZE" in os.environ:
            r = v3_across_cards(counters, dataset)
            if int(os.environ.get("RANK", 0)) == 0:
                cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                        "--format=csv,noheader"], capture_output=True,
                                       text=True, timeout=60, check=True).stdout.split("\n")
                print(json.dumps({"phase8": r, "cards": [c.strip() for c in cards if c.strip()]}))
            return
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"phase8": run_v3(counters, dataset, smi)}))
        return
    if "--phase9" in sys.argv[1:]:
        # phase 9 alone, on one card
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        r = run_telemetry(counters, SyntheticDataset(num_samples=STEPS * BATCH,
                                                     image_size=224), smi)
        print(smi)
        print(json.dumps({"phase9": r}, default=str))
        return
    if {"--phase11", "--phase11d"} & set(sys.argv[1:]):
        # phase 11 alone: (a)-(c) on one card, (d) where there are four;
        # --phase11d: (d) alone
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        r = run_supervised(counters, smi, only_d="--phase11d" in sys.argv[1:])
        print(smi)
        print(json.dumps({"phase11": r}, default=str))
        return
    if {"--phase12", "--phase12d"} & set(sys.argv[1:]):
        # phase 12 alone on one card; --phase12d: its four-card run
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        r = (sync_bn_across_cards(smi) if "--phase12d" in sys.argv[1:]
             else run_sync_bn_and_service(counters, smi))
        print(smi)
        print(json.dumps({"phase12": r}, default=str))
        return
    if "--phase13" in sys.argv[1:]:
        # phase 13 alone, on one card
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        r = run_serving(counters, smi)
        print(smi)
        print(json.dumps({"phase13": r}, default=str))
        return
    if "--phase14" in sys.argv[1:]:
        # phase 14 alone, on one card: it makes its own exports and bank
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        r = run_fleet(counters, smi)
        print(smi)
        print(json.dumps({"phase14": r}, default=str))
        return
    if "--phase10" in sys.argv[1:]:
        # phase 10 alone, on one card
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        r = run_resilience(counters, SyntheticDataset(num_samples=STEPS * BATCH,
                                                      image_size=224), smi)
        print(smi)
        print(json.dumps({"phase10": r}, default=str))
        return
    if "--phase15d" in sys.argv[1:]:
        # phase 15's (d) under a two-process torchrun, started by --phase15's rank 0
        r = fsdp_restore_check(Path(sys.argv[sys.argv.index("--phase15d") + 1]))
        if int(os.environ.get("RANK", 0)) == 0:
            print(json.dumps(r, default=str))
        return
    if "--phase15" in sys.argv[1:]:
        # phase 15 alone: under `torchrun --nproc-per-node <cards> chip_smoke.py
        # --phase15` (a)-(d) across the cards, else the one-card run
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        dataset = SyntheticDataset(num_samples=STEPS * BATCH, image_size=224)
        if "WORLD_SIZE" in os.environ:
            r = fsdp_across_cards(counters, dataset, smi)
            if int(os.environ.get("RANK", 0)) == 0:
                cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                        "--format=csv,noheader"], capture_output=True,
                                       text=True, timeout=60, check=True).stdout.split("\n")
                print(json.dumps({"phase15": r, "cards": [c.strip() for c in cards
                                                          if c.strip()]}, default=str))
            return
        r = run_fsdp(counters, dataset, smi)
        print(smi)
        print(json.dumps({"phase15": r}, default=str))
        return
    if "--phase16" in sys.argv[1:]:
        # phase 16 alone, on one card: config 1 and its journey
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        r = run_config1(counters, stats, smi)
        print(smi)
        print(json.dumps({"phase16": r}, default=str))
        return
    if "--phase7" in sys.argv[1:]:
        # phase 7 alone, across every card: under
        # `torchrun --nproc-per-node <cards> chip_smoke.py --phase7`
        runs = sync_modes_in_group(counters, SyntheticDataset(num_samples=STEPS * BATCH,
                                                              image_size=224))
        if int(os.environ.get("RANK", 0)) == 0:
            print(json.dumps({"phase7": runs, "ranks": int(os.environ.get("WORLD_SIZE", 1))}))
        return

    report = check_stats_kernels(stats)
    report["gaussian_blur_batch"] = {"224px": check_blur_kernel(blur)}
    report.update(check_fused_kernels(fused_conv, fused_conv3x3))
    from moco_tpu_torch.config import get_preset

    # one epoch holds every step of phases 3 and 3b: each step's batch is
    # staged while the one before it runs
    dataset = SyntheticDataset(num_samples=STEPS * BATCH, image_size=224)
    config = get_preset("imagenet-moco-v2").replace(dataset="synthetic")
    check_prefetched(dataset, "slice")
    summary = run_slice(counters, "slice", config, dataset, STEPS)
    fused_summary = run_slice(counters, "fused", config.replace(fused_bn_conv=True), dataset,
                              FUSED_STEPS)
    run_distributed(counters, dataset)
    sync_modes_in_group(counters, dataset)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    run_v3(counters, dataset, smi)
    run_telemetry(counters, dataset, smi)
    run_resilience(counters, dataset, smi)
    run_supervised(counters, smi)
    run_sync_bn_and_service(counters, smi)
    run_fsdp(counters, dataset, smi)
    del dataset
    print(f"slice vs fused: {summary['imgs_per_s']:.1f} vs {fused_summary['imgs_per_s']:.1f} "
          f"imgs/s, peak memory {summary['max_memory_gib']:.2f} vs "
          f"{fused_summary['max_memory_gib']:.2f} GiB", flush=True)
    folder = run_imagefolder(counters)
    # the profiler's own host time a step lengthens the profiled step's wall;
    # the steady step (host clock, not profiled) less the profiled device busy
    # time estimates the device's idle time in a step without it
    for label, r in (("slice", summary), ("fused", fused_summary), *folder.items()):
        print(f"input path {label}: {r['imgs_per_s']:.1f} imgs/s, peak memory "
              f"{r['max_memory_gib']:.2f} GiB, profiled step device busy/wall "
              f"{r['busy_ms']:.2f}/{r['wall_ms']:.2f} ms, steady step less busy "
              f"{1e3 * r['steady_step_s'] - r['busy_ms']:.2f} ms, in-epoch step less busy "
              f"{1e3 * (r['in_epoch_step_s'] or math.nan) - r['busy_ms']:.2f} ms", flush=True)
    check_against_cpu()
    check_against_cpu(fused=True, counters={k: counters[k] for k in FUSED_PER_STEP})

    run_checkpoint_and_evals(counters, smi)
    with _serving_dir(None, "moco_serving_") as serving:
        # phase 14's fleet serves phase 13's exports and bank
        run_serving(counters, smi, serving)
        run_fleet(counters, smi, serving)
    run_config1(counters, stats, smi)
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    # name: (source, TPU kernel it replaces, shape reported in the line)
    sources = {
        "channel_sums": ("channel_stats.cu", "moco_tpu/ops/pallas_stats.py:121", "stem"),
        "channel_grad_sums": ("channel_stats.cu", "moco_tpu/ops/pallas_stats.py:155", "stem"),
        "gaussian_blur_batch": ("blur.cu", "moco_tpu/ops/pallas_blur.py:77", "224px"),
        "bn_relu_matmul": ("matmul_fwd.cu", "moco_tpu/ops/pallas_fused_conv.py:137", "layer1"),
        "bn_relu_matmul_dw": ("matmul_dw.cu", "moco_tpu/ops/pallas_fused_conv.py:101", "layer1"),
        "bn_relu_conv3x3": ("conv3x3_fwd.cu", "moco_tpu/ops/pallas_fused_conv3x3.py:237",
                            "layer1"),
        "bn_relu_conv3x3_s2": ("conv3x3_fwd.cu", "moco_tpu/ops/pallas_fused_conv3x3.py:351",
                               "layer2"),
        "conv3x3_dw": ("conv3x3_dw.cu", "moco_tpu/ops/pallas_fused_conv3x3.py:412", "layer1"),
    }
    kernels = []
    for name, (source, replaces, shape_name) in sources.items():
        r = report[name][shape_name]
        run = fused_summary if name in FUSED_PER_STEP else summary
        kernels.append(dict(name=name, route="cuda", source=f"moco_tpu_torch/csrc/{source}",
                            replaces=replaces, launches=run["launches"][name],
                            max_abs_err=max(v["max_abs_err"] for v in report[name].values()),
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            shape=r["shape"],
                            **{k: r[k] for k in ("device_ms", "library_device_ms") if k in r}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--load-client"]:
        _load_client(sys.argv[2])  # phase 14's clients, in a process of their own
    else:
        main()
