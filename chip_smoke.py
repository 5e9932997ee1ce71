#!/usr/bin/env python3
"""Drive cxxnet_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc). Phases, each of which raises on failure:

1. device: the card's name and power limit, and which of jpeglib.h,
   png.h, nvjpeg.h, libnvjpeg and g++ the machine has (looked for: what
   the image decoder builds on);
2. build: every kernel in cxxnet_tpu_torch/csrc/ compiled with nvcc
   (one process per source, started together), with the -Xptxas -v
   register and shared-memory lines; each tensor-core instance (K2-fwd,
   K2-dq, K2-dkv in bfloat16, K3 in int8) with its tile plan, registers,
   spills (none allowed) and shared memory, and the count of HGMMA /
   IGMMA instructions in each library's SASS (cuobjdump); each LRN
   instance (K1-fwd, K1-bwd in each dtype: the n = 5 ring, the generic
   and the direct instance) with its registers, stack frame and spills
   (none allowed), and lrn_plan's launch plan at
   AlexNet's and GoogLeNet's LRN shapes;
3. kernel vs plain (3, 3b): K1-fwd and K1-bwd each against its plain
   PyTorch version at the main paths' shapes, at ragged ones, at the
   slab cases (GoogLeNet's 56 x 56, C below the halo, batch 1, windows
   wider than the chunk, H*W cut into segments), at a window too wide
   for any slab (the direct instance) and on a view off
   16-byte alignment, with times (CUDA events, warm and L2-cold; at the
   main paths' shapes also the kernel's device time from
   torch.profiler, apart from the enqueue rate), the one-call library
   yardstick and the bound;
3c. flash attention: K2-fwd, K2-dq and K2-dkv against their plain
   versions at seq_mnist's shape (100,4,28,7), at ragged shapes, at
   head_dim 12 and 200, at Sq != Sk, on 2-byte-aligned views and at the
   JAX package's measuring shape (4,8,4096,128); every K2 kernel
   launched twice gives the same bits. Times (CUDA events, warm and
   L2-cold), the bound and scaled_dot_product_attention's forward and
   backward as the library yardstick, the backward pair's factor
   against that one backward call, and forward + backward through
   autograd beside SDPA's; K2-fwd's tile plan at each timed shape;
4. serving: examples/ImageNet/AlexNet.conf at full width (bfloat16, as
   the file says) through the port's NetTrainer and Server - ragged
   requests from two threads, served rows against predict_dist, the
   LRN kernel launched twice per dispatched batch - then a float32 leg
   (TF32 off) against the same rows through the port on the CPU;
5. CLI: task=pred and task=serve of `python -m cxxnet_tpu_torch.main`
   on a synthetic MNIST-format dataset with an lrn layer, on the
   default device: identical output files, kernel launches > 0;
6. training: AlexNet.conf unmodified (b256, bfloat16, SGD + momentum,
   dropout) through NetTrainer.update - 2 warm-up and 10 timed steps,
   both LRN kernels launched twice per step, the loss finite, the
   params moved, a repeated batch fitted; a profiler table of the
   busiest CUDA ops and the device's idle share; then a float32 step
   (TF32 off, batch 8) on the card against the same step on the CPU;
7. CLI training: `task = train` for 3 rounds on the default device
   (test error falls), `continue = 1` resumes, an empty model_dir
   fails, `task = pred` reads the result;
8. the sequence family: examples/LongSeq/seq_mnist.conf unmodified
   (b100, bfloat16) - (a) NetTrainer.update, 2 warm-up and 10 timed
   steps, each launching every K2 kernel once, with a profiler table,
   the device's idle share and K2-fwd's device time per step; (b) a
   float32 step (TF32 off, batch 8) on the card against the CPU; (c)
   the CLI's task = train (3 rounds, test error falls), continue = 1
   and task = pred on synthetic MNIST-format data under ./data/ of a
   temporary directory; (d) the
   Server over (a)'s trainer, answering ragged requests of 1-100 rows
   from two threads, one K2-fwd per dispatched batch. (d) runs before
   (c);
9. int8 (K3) and the graph passes: (a) K3 against its plain version,
   bitwise, at AlexNet's fullc shapes (m = 64), bench.py's int8 MLP
   (m = 16), ragged shapes, AlexNet b64's convolution GEMMs, the
   measuring shape (4096,4096,4096) and views one byte off alignment,
   with times (warm, L2-cold), torch._int_mm as the yardstick and the
   bound, summed over fc6-8 and over the 8 conv GEMMs; (b) AlexNet.conf
   (bfloat16, max_batch 64) with graph_passes = dead_layer_elim,
   elim_reshape,fuse_activation,quantize_int8, calibrated on the first
   batch and served to phase 4's 30 ragged requests from two threads:
   served rows against predict_dist, 11 K3 launches per batch, the
   split of latency, the int8 graph's rows against the float graph's;
   (c) every quantized site's int32 accumulator, K3's route against
   the plain version, and a float32 int8 forward (TF32 off, b8) on the
   card against the CPU; (d) bench.py's int8 MLP pair at b16
   (int8_over_fold, argmax agreement on 256 rows); (e) the CLI's task =
   pred and task = serve with the int8 passes (identical outputs,
   pass_calibration_batches and pass_calibration_iter);
10. the image data pipeline: (a) whether PIL imports, scipy's version,
   the CPU count and the synthetic set's format (JPEG where PIL is
   present, else binary P6); (b) 256 x 256 imgbin sets packed with the
   port's im2bin; (c) examples/ImageNet/AlexNet.conf through the CLI,
   unedited (b256, bfloat16, imgbin + threadbuffer, the mean image made
   on the first run): 2 rounds with their eval lines, K1-fwd and K1-bwd
   launched, `continue = 1`, and `task = pred` (256 lines) with a pred
   block appended; (d) ResNet18.conf and kaggle_bowl/bowl.conf, 2 rounds
   each, side by side, then kaggle_bowl/pred.conf (task = pred_raw) on
   bowl's model;
   (e) StagedPrefetcher's tensors (pinned ring, side stream) against
   streamed staging, bitwise, for two AlexNet batches under stage_dtype
   bfloat16 and float32 and device_augment = 1; (f) ops/augment.py on
   the card against the host augmenter given its replayed draws,
   bitwise; (g) AlexNet b256 bfloat16 from AlexNet.conf's train block
   over 3,072 images, streamed, prefetch_stage = 1 and prefetch_stage =
   1 + device_augment = 1: step time, images/s, staging, the device's
   idle share, the iterator's own rate, and which of them sets the pace
   - (g) runs in a fresh python process (`chip_smoke.py --leg 10g OUT
   DIR FORMAT`), as phase 11's profiled legs do;
11. the last layer types - (a), (b) and (d)'s steps each run in a fresh
   python process of their own (`chip_smoke.py --leg 11a|11b|11d OUT`),
   since in a long-lived process torch.profiler can lose the card's
   kernel events; there a trace without kernel events fails the leg,
   which runs once more in another fresh process and then fails the
   script. (a) runs after phase 3b, (b) and (d) after phase 9, (c) and
   (d)'s CLI after phase 10: (a) K1-fwd and K1-bwd at GoogLeNet.conf's b256
   LRN shapes (256,64,56,56) and (256,192,56,56), float32 and bfloat16,
   against their plain versions, with the plan, times, device time and
   the bound; (b) examples/ImageNet/GoogLeNet.conf unedited (b256,
   bfloat16: 9 ch_concat, 13 max-pools, 2 LRNs) on one staged batch, 2
   warm-up and 5 timed steps with a profile (the ties max-pool
   backward's and K1's device time per step, the idle share, peak
   memory), then a float32 step (TF32 off, b8) card vs CPU with the
   CPU replaying the card's ties max-pool routing; (c)
   GoogLeNet.conf through the CLI on phase 10's imgbin set: 2 rounds,
   continue = 1, task = pred; (d) examples/LongSeq/stack_moe.conf (4
   stacked transformer blocks, a top-2 moe): the CLI's 2 rounds and
   task = pred on synthetic MNIST-format data, b100 bfloat16 steps (4
   launches of each K2 kernel a step), the Server burst of phase 8d (4
   K2-fwd a batch) and a float32 step card vs CPU with the moe aux
   term;
12. the serving front, in a fresh process (`chip_smoke.py --leg 12 OUT`):
   AlexNet.conf unedited (bfloat16, max_batch 64, 2 replicas) with a
   second weight set saved and published with publish_model - (a)
   phase 4's 30 requests through the front's lanes (a CUDA stream and
   a pinned buffer per replica) and through the old default-stream path,
   in the order new, old, old, new: rows/s and p50/p99 (end to end,
   queue, device), K1-fwd twice a batch, rows at phase 4's bfloat16
   bar, the idle share of one profiled burst; (b) 24 POST /predict
   requests of 1-8 rows from 4 client threads (JSON bodies of 154,587
   floats a row: the server's parse is part of what is timed), rows
   against predict_dist, /metrics through validate_exposition, an
   over-size body's 413; (c) a storm past queue_limit: 429 with
   Retry-After in [1, 60], /healthz 503 then 200 after
   serve_shed_clear_ms, and a deadline behind stalled dispatches
   answering 504; (d) a hot-swap mid-storm from the published
   checkpoint: nothing dropped, every response the old or the new
   weights' rows, the bucket programs flat; (e) a canary promoted and
   one rolled back (canary_divergence injected) with the incumbent
   slot bitwise unchanged; (f) a second Server on the int8 graph behind
   /predict, K3 11 times a batch; (g) task = serve through the CLI with
   serve_port and metrics_port, /metrics scraped while it serves, then
   SIGTERM: exit 0 and every admitted row in the output;
13. the reference's own surface, in a fresh process (`chip_smoke.py
   --leg 13 OUT [DIR]`, run inside phase 10's directory after 11c;
   alone it makes its own imgbin set), AlexNet.conf b256 bfloat16
   unless said: (c) wrapper.train on numpy arrays, 256 images (staged
   once) and 1,024 (prefetched), 2 rounds each, the first step equal in
   both, images/s of round 2 and the idle share of one profiled round;
   (b) one round through the CLI with model_format = cxxnet: the file's
   size against the byte count worked out from the conf, the reloaded
   net's predict_dist rows bitwise, task = finetune from it; (a) task =
   extract through the CLI of node 20 (fc7 after relu and dropout) by
   name and as top[-2], text and raw, and top[-1]: the same bytes, the
   .meta lines, the rows against NetTrainer.extract_feature bitwise and
   top[-1] against predict_dist at phase 4's bar, K1-fwd twice a batch,
   rows/s; then Net.extract against those rows and fc8's get / set
   weight, bitwise; (d) the C ABI library and capi_driver.c built with
   g++, the driver run with device gpu (4 CXNNetUpdateBatch steps of 256
   x 3 x 227 x 227, predict, extract, save, load, get / set weight), its
   K1 launches from the shim's launch log, its rows against wrapper.Net
   at phase 4's bar, images/s; (e) the extra-input net of
   tests/test_trainer.py:505 trained on numpy batches, the pinned ring
   carrying extras, Server.submit and /predict with extras (200) and
   without (400); (f) keep_latest = 2 with continue = 1, and test_io =
   1, through the CLI on MNIST.conf (in the whole script, beside phase
   10's CLI runs: it checks and times nothing);
14. the native image decoder (`use_native`, io/native.py over
   csrc/nvjpeg_io.cu), in a fresh process (`chip_smoke.py --leg 14 OUT
   [DIR FMT]`, run inside phase 10's directory after 13; alone it makes
   its own timing set): (a) the library built, its backend, nvJPEG's
   version and path, the hardware decoder's facts, and its kernel
   YccToRgb against its plain version bitwise at 256 x 256 (4:2:0 and
   4:4:4) with its time and bound; (b) a 4:4:4, a 4:2:2 and a 4:2:0 set
   of 512 images and a 4:4:0, a 4:1:1, a grayscale and an R, G, B set of
   128, 256 x 256, quality 90: every record against PIL's decode of the
   same blob at io/native.py's PIL_BAR, with the distribution, every
   record decoded on the card;
   then stream order on 4 workers over 3 passes with the counters, two
   bins, a missing file, PNG / PPM / a JPEG cut in its headers handed
   back raw, out_mode 1 against 2; (c) AlexNet.conf's train block under
   use_native = 1 and shuffle = 1 on the card against PlainBinReader:
   labels bitwise, batches at the bar ((b)-(c) check and time nothing:
   in the whole script they run in a process of their own, `--leg 14u
   OUT`, beside phase 10's CLI runs); (d) the decode rate alone over
   10g's 3,072 images at 1, 4 and 8 threads beside PIL's at 1 and 4;
   (e) 10g's three settings again with use_native = 1, with the host
   stages; (f), in this process: phase 10c's CLI run, which under the
   conf's use_native = -1 decodes with nvJPEG - the decoder launched,
   no raw hand-back;
15. the trainer's last single-device keys, in a fresh process
   (`chip_smoke.py --leg 15 OUT [DIR]`, run inside phase 10's directory
   after 14; alone it makes its own imgbin set): (a) AlexNet.conf b256
   bfloat16 on 8 cached batches, update_period = 2, check_nan = 1,
   batch 5 poisoned with NaN: steps_per_dispatch = 4 (two fused
   chunks) against 8 update() calls - params and updater state
   bitwise, the NaN microstep dropped in both, K1's launches equal, one
   guard readback a chunk (8 against 2), the synchronising calls of one
   chunk (torch's sync debug mode), the step time a microstep and the
   device's idle share of each; (b) and (d), CLI runs that check and
   time nothing, run side by side (in the whole script, beside phase
   10's CLI runs); (b) seq_mnist.conf through the CLI at
   K = 4 against K = 1 (tools/fused_smoke.py: checkpoints byte-equal,
   eval lines equal, train.chunk spans, K2's launches); (c) remat = 1
   against 0 at AlexNet b256 over 2 updates: the params (bitwise, or no
   further apart than two remat = 0 runs), peak device memory (lower),
   K1-fwd launched twice as often; (d) AlexNet.conf through the CLI for
   2 rounds with profile = 1, profile_dir and trace_round = 2: the
   summary lines, exactly one Chrome trace holding K1's kernels, the
   `round` events; (e) tools/autotune.py over K in {1, 4} on
   MNIST_CONV.conf writes a "gpu" cache entry, the CLI takes
   steps_per_dispatch from it, and an explicit key beats it.
16. the analysis tier and the tools (`chip_smoke.py --leg 16 OUT` runs it
   alone), each in a process of its own under a time limit: (a) the
   graph audit (`python -m cxxnet_tpu_torch.analysis --graph-audit`):
   every check on the card, kernel-routing included - AlexNet.conf's
   served bf16 b64 bucket launches K1-fwd 2, its b64 step K1-fwd 2 and
   K1-bwd 2, the int8 bucket K3 11, seq_mnist.conf's b100 step K2-fwd,
   K2-dq and K2-dkv 1 each, with no plain version, no SDPA and no
   `_int_mm` - and the guard's one readback a K = 4 chunk under
   `torch.cuda.set_sync_debug_mode`; (b) the lock audit with serve-storm
   and native-decode (an acyclic lock-order graph, no audited lock held
   across a card sync), and its seeded-inversion leg, which must fail;
   (c) tools/pass_smoke.py on the card - (a), (b) and it run side by
   side, they check and do not time - then tools/serve_http_smoke.py
   alone (its storm bounds latency) and tools/bench_pool.py alone, in
   this process; (d) tools/bench_attn.py --quick alone, in this process.
   Every time of 16 stands beside the card's name and power limit.
17. data parallelism, two ranks sharing the one card over gloo
   (`chip_smoke.py --leg 17 OUT` runs it alone): (a)
   examples/MNIST/dist.conf, unedited (param_server = dist, mesh =
   data:2, update_on_server = 1: ZeRO-1), under tools/launch_dist -n 2
   with num_round = 2 over 1,000 images, dev = gpu:0 and test_on_server
   = 1, beside the same job with dev = cpu: the round lines and rank 0's
   last checkpoint held to the CPU's; (b) AlexNet.conf at full width,
   global batch 256 (128 a rank), DP_STEPS steps a leg (1; 2 before the
   seq axis's phase 19 joined the budget) in two spawned workers
   (`--leg 17w`) at
   update_on_server = 0 and 1: the float32 legs replay the one-process
   b256 run's decisions (ops/routing.py) and hold each update within
   UPDATE_BAR of its norm, the bfloat16 legs hold the global loss to the
   one-process run's; K1-fwd / K1-bwd 2 / 2 a step on each rank, no plain
   version, no F.local_response_norm; the updater state each rank holds
   (ZeRO-1 halves the cut weights'), a step's time, the all-reduce's
   and, at update_on_server = 1, ZeRO-1's all-gather's, as two ranks
   sharing one card; (c) seq_mnist.conf as two ranks, K2
   1-1-1 a step on each, no SDPA. Each worker prints its counts and
   verdicts on one `dp-result` line the phase reads.
18. ZeRO stages 2-3 and the model axis, ranks sharing the one card over
   gloo (`chip_smoke.py --leg 18 OUT` runs it alone). What checks and
   times nothing runs in `--leg 18u OUT WORK`, beside phase 16a-c: the
   one-process b256 references (17b's and 18's), then (b) AlexNet.conf
   at mesh = model:2, each of two workers (`--leg 18w`) on all 256
   rows, float32 replaying the one-process decisions (each update
   within UPDATE_BAR) and bfloat16 holding the global loss, each rank's
   conv / fc weight bytes, and (c) seq_mnist.conf (nhead 4) at model:2,
   K2 1-1-1 a step on each rank on its 2 heads; from the start, side by
   side with them, 17a, (d) examples/MNIST/MNIST_CONV.conf (1,000
   images) at mesh = data:2,model:2 under zero_stage = 3, four ranks under
   tools/launch_dist on the card beside the same job with dev = cpu
   (its dropout layer taken out; round lines and rank 0's last
   checkpoint held to the CPU's as 17a's, test_on_server = 1), and (e)
   the port's tools/zero_smoke.py --dev gpu:0. Then, alone after 17:
   (a) AlexNet.conf at global batch 256, mesh = data:2 at zero_stage 2
   and 3 (float32) and 1 and 3 (bfloat16), held alike, the bytes of
   params, gradients, accumulator and updater state each rank holds,
   the reduce-scatter's and the all-gather's times. K1-fwd / K1-bwd 2 /
   2 a step on each rank in (a) and (b), no plain version, no
   F.local_response_norm, no SDPA.
19. the seq axis, ranks sharing the one card over gloo (`chip_smoke.py
   --leg 19 OUT` runs it alone). What checks and times nothing runs in
   `--leg 19u OUT WORK`, beside phase 16a-c with 18u: (a)
   examples/LongSeq/seq_mnist.conf with its own `mesh = data:2,seq:2`
   line uncommented (its dropout layer taken out, as 18d's), four ranks,
   dev = gpu:0, 2 rounds, test_on_server = 1: as shipped (b100, 4
   heads, bfloat16) through the CLI under tools/launch_dist (round
   lines, finite weights, each rank's K2 launches), and beside it, in
   four worker processes that run the CLI's LearnTask one job after
   the other (`--leg 19r`), in float32 on the card and on the CPU: the
   round lines within 0.01 and rank 0's last checkpoint within rtol
   1e-3 / atol 1e-5 of the CPU's; then (c) the same conf at zero_stage
   = 2, refused by every rank with the JAX trainer's text. Then, alone after 18: (b) ring and Ulysses attention
   at mesh = seq:2 over two workers (`--leg 19w`), (1,8,8192,128)
   bfloat16, causal and not: each rank's output block and q / k / v
   gradient blocks against flash_attention on the whole sequence in its
   own process (attn_close's bfloat16 bar), K2-fwd / K2-dq / K2-dkv
   launched as the schedule says (the ring 2-2-2 a call, 1-1-1 on seq
   rank 0 under causal; Ulysses 1-1-1), no plain version, no SDPA; a
   step's time and its host-staged exchange's with CUDA events and the
   host clock, and K2 alone at (1,8,4096,128) beside them (in the whole
   script, run from the script's own process after 18). 16a's graph audit adds its seq
   audit (seq_mnist.conf at seq:2 on two ranks, ring then Ulysses,
   kernel-routing on each rank).

It prints one JSON line with every kernel's numbers, then, as the last
line, {"ok": true, "device": {...}}. With no card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import ast
import contextlib
import gzip
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (NVIDIA): device memory rate and the float32 rate
# outside the tensor cores - what the LRN's bound is taken against
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# dense bfloat16 tensor-core rate of the H100 SXM (data sheet): what the
# attention kernels' bound is taken against in bfloat16
BF16_FLOPS_PER_S = 989.4e12

# the float32 card-vs-CPU steps (f32_step_card_vs_cpu): the most that a
# tensor's update may differ from the CPU's, in relative norm, once the
# CPU leg replays the card's max-pool tie sets and relu gates. Rounding
# alone then moves the updates at batch 8 by up to 2.7e-4 (AlexNet),
# 1.9e-5 (GoogLeNet), 1.8e-5 (stack_moe) and 4.1e-6 (seq_mnist) on an
# H100, and by up to 4e-4 between two CPU legs at 8 and 1 threads
# (GoogLeNet, b16); a 1% fault in one inception branch moves that
# branch's updates by ~1e-2
UPDATE_BAR = 2e-3

# the inputs of AlexNet's two LRN layers in a b256 training step
TRAIN_LRN_SHAPES = ((256, 96, 27, 27), (256, 256, 13, 13))

# the inputs of AlexNet's two LRN layers at a served batch of 64
SERVE_LRN_SHAPES = ((64, 96, 27, 27), (64, 256, 13, 13))

# the LRN kernels' slab cases (tests/test_torch_cuda.py: SLAB_CASES):
# GoogLeNet's LRN inputs (even H*W; the backward's rows cut into
# segments), C below the halo, C not a multiple of the chunk, batch 1,
# windows wider than the chunk (the generic instances) and H*W cut
# into many segments; each in float32 and bfloat16
GOOGLENET_LRN_SHAPES = ((32, 64, 56, 56), (32, 192, 56, 56))
SLAB_CASES = tuple((shape, 5) for shape in GOOGLENET_LRN_SHAPES) + (
    ((3, 2, 4, 4), 7), ((2, 40, 3, 3), 5), ((1, 96, 27, 27), 5),
    ((2, 40, 3, 3), 41), ((2, 70, 5, 5), 9), ((1, 16, 300, 300), 3))
# windows over so many channels that no slab fits shared memory: the
# direct instances (lrn_plan's seg 0), forward and backward
NO_SLAB_FWD = ((1, 8000, 4, 4), 7501)
NO_SLAB_BWD = ((1, 8000, 4, 4), 2501)
UNTIMED_LRN_SHAPES = tuple(shape for shape, _ in SLAB_CASES[2:]) + (
    NO_SLAB_FWD[0],)
# a contiguous view whose base is 2 (bfloat16) or 4 (float32) bytes past
# a 16-byte boundary: x[1:] of this shape
VIEW_BASE = (2, 13, 5, 7)

# seq_mnist.conf's attention core (b100, 4 heads, 28 steps, head_dim 7)
# and the JAX package's flash-attention measuring shape (bench.py:420)
SEQ_ATTN_SHAPE = (100, 4, 28, 7)
MEASURE_ATTN_SHAPE = (4, 8, 4096, 128)


_T0 = time.monotonic()
# the lines of a phase run by side_by_side, kept until it ends
_HELD = threading.local()


def say(line: str) -> None:
    """One line of the report; a phase's header carries the seconds since
    this process started."""
    if line.startswith("== "):
        line += f" [t = {time.monotonic() - _T0:.0f} s]"
    _emit(line)


def _emit(line: str) -> None:
    held = getattr(_HELD, "lines", None)
    if held is not None:
        held.append(line)
        return
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def side_by_side(*fns):
    """Run the phases `fns` at once, each on a thread of its own: phases
    that check and time nothing (CLI children, mostly), so the card and
    the host's cores carry them together. Each phase's lines are printed
    whole, in the order given, when all have ended; the first failure is
    raised then. Returns their results in order."""
    results = [None] * len(fns)
    errors = [None] * len(fns)
    lines = [[] for _ in fns]

    def run(i):
        _HELD.lines = lines[i]
        try:
            results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
        finally:
            _HELD.lines = None

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in
               range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for held in lines:
        for ln in held:
            _emit(ln)
    say(f"({len(fns)} phases side by side took "
        f"{time.perf_counter() - t0:.1f} s)")
    for e in errors:
        if e is not None:
            raise e
    return results


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers: timing with CUDA events
# ---------------------------------------------------------------------------

def time_warm(torch, fn, iters: int = 50) -> float:
    """Mean ms per call over `iters` back-to-back calls (L2 warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cold(torch, fn, flush, iters: int = 20) -> float:
    """Mean ms per call with the 50 MB L2 flushed before each call (a
    256 MB buffer written between calls, outside the timed window)."""
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def lrn_bound_ms(shape, itemsize: int, n: int):
    """Least time for one LRN: the larger of its bytes (each input read
    once, each output written once) over the memory rate and its
    float32 operations (window squares and adds, the norm's multiply-
    add, pow counted as 3, the final multiply) over the float32 rate."""
    elems = 1
    for d in shape:
        elems *= d
    bytes_ms = 2 * elems * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = elems * (2 * n + 6) / F32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def bf16_ulp_close(torch, got, ref) -> bool:
    """Every element within one bfloat16 ulp of the reference (both
    round float32 math to bfloat16; one rounding boundary apart at
    most)."""
    g, r = got.float(), ref.float()
    ulp = torch.where(r == 0, torch.full_like(r, 2.0 ** -133),
                      torch.abs(r) * 2.0 ** -7)
    return bool(torch.all(torch.abs(g - r) <= ulp))


def lrn_cases(torch, main_shapes, no_slab):
    """(shape, dtype, n, view) of phases 3 and 3b: the main paths'
    shapes, the ragged ones, the slab cases, the `no_slab` case (the
    direct instance) and the view off 16-byte alignment (view=True:
    x[1:] of VIEW_BASE)."""
    dts = (torch.float32, torch.bfloat16)
    cases = [(shape, dt, 5, False) for shape in main_shapes for dt in dts]
    for c in (3, 13):
        for hw in ((1, 1), (5, 7)):
            for n in (1, 2, 4, 7):
                for dt in dts:
                    cases.append(((3, c) + hw, dt, n, False))
    cases += [(shape, dt, n, False) for shape, n in SLAB_CASES + (no_slab,)
              for dt in dts]
    cases += [((1,) + VIEW_BASE[1:], dt, n, True) for n in (2, 5, 19)
              for dt in dts]
    return cases


def lrn_input(torch, gen, shape, dt, view, scale=4.0):
    """A random CUDA tensor of `shape`; with view, x[1:] of a fresh
    (2, ...) tensor - contiguous, 16-byte alignment broken."""
    if not view:
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    base = (torch.randn((2,) + tuple(shape[1:]), generator=gen,
                        device="cuda") * scale).to(dt)
    x = base[1:]
    if not x.is_contiguous() or x.data_ptr() % 16 == 0:
        raise AssertionError("the view should be contiguous and off "
                             "16-byte alignment")
    return x


def ms_txt(v) -> str:
    """A time for a report line: ms, or "not measured" for None."""
    return "not measured" if v is None else f"{v:.4f} ms"


def lrn_device_ms(torch, fn, kernel: str, iters: int = 20,
                  strict: bool = False):
    """The kernel's own device time per call (torch.profiler's kernel
    events), apart from the host's enqueue rate that back-to-back
    CUDA-event times include at small shapes; None when the profiler
    recorded no kernel (ProfilerLost where `strict`)."""
    _, groups, busy, _ = profile_steps(torch, fn, iters,
                                       (("k", "kernel", kernel),), strict)
    return groups["k"] if busy else None


def say_lrn_plans(torch) -> None:
    """Phase 2: the plan of each LRN launch on the main paths and of
    GoogLeNet's LRN inputs."""
    from cxxnet_tpu_torch.ops.lrn import lrn_plan
    for shape in SERVE_LRN_SHAPES + TRAIN_LRN_SHAPES + GOOGLENET_LRN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            for bw in (False, True):
                p = lrn_plan(shape, 5, dt, bw)
                say(f"{'lrn_bwd' if bw else 'lrn_fwd'} plan {shape} "
                    f"{str(dt)[6:]} n=5: chunk {p['chunk']}, segment "
                    f"{p['seg']} ({'whole H*W' if p['whole'] else 'rows'})"
                    f", {p['threads']} threads, {p['smem_bytes']} B "
                    f"shared, {p['blocks']} blocks")


LRN_INSTANCE = re.compile(r"(lrn_(?:fwd|bwd))_(kernel|direct)"
                          r"I(f|13__nv_bfloat16)(?:Li(\d+)E)?E")


def say_lrn_instances(built) -> None:
    """Phase 2: each LRN kernel instance (dtype; the ring instance of
    n = 5, the generic slab instance or the direct one) with its
    registers, stack frame and spills from nvcc -Xptxas -v; a spill
    raises."""
    for name in ("lrn_fwd", "lrn_bwd"):
        log = built.get(name, (0.0, ""))[1]
        if log == "cached":
            say(f"{name}: library cached, no ptxas report")
            continue
        cur, frame, seen = None, ("?", "?", "?"), 0
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                cur = LRN_INSTANCE.search(ln)
            elif cur is not None and "stack frame" in ln:
                frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                  r"spill stores, (\d+) bytes spill loads",
                                  ln).groups()
            elif cur is not None and "registers" in ln:
                regs = re.search(r"Used (\d+) registers", ln).group(1)
                dt = "float32" if cur.group(3) == "f" else "bfloat16"
                n = cur.group(4)
                kind = ("direct" if cur.group(2) == "direct" else
                        f"n={n}" if n != "0" else "generic")
                say(f"{name} instance {dt} {kind}: {regs} registers, stack "
                    f"frame {frame[0]} B, spill stores {frame[1]} B, spill "
                    f"loads {frame[2]} B")
                if frame[1:] != ("0", "0"):
                    raise AssertionError(f"{name} {dt} {kind} spills")
                cur, frame = None, ("?", "?", "?")
                seen += 1
        # (n = 5, generic, direct) x 2 dtypes
        if seen != 6:
            raise AssertionError(f"{name}: {seen} instances in the ptxas "
                                 "report, expected 6")


def phase_kernels(torch):
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.lrn import lrn, lrn_reference

    say("== phase 3: LRN kernel vs plain version ==")
    alpha, beta, knorm = 0.001, 0.75, 1.0
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    max_err = 0.0
    main_rows = {}
    # the serving path's shapes (batches of 64) and the training path's
    # (AlexNet's b256), the ragged and slab cases, the misaligned view
    cases = lrn_cases(torch, SERVE_LRN_SHAPES + TRAIN_LRN_SHAPES,
                      NO_SLAB_FWD)
    for shape, dt, n, view in cases:
        x = lrn_input(torch, gen, shape, dt, view)
        got = lrn(x, n, alpha, beta, knorm)
        torch.cuda.synchronize()
        ref = lrn_reference(x, n, alpha, beta, knorm)
        lib = F.local_response_norm(x.float(), n, alpha, beta, knorm)
        err = float((got.float() - ref.float()).abs().max())
        rel = float(((got.float() - ref.float()).abs()
                     / ref.float().abs().clamp_min(1e-30)).max())
        if dt == torch.float32:
            ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-6)
            lib_ok = torch.allclose(got, lib, rtol=1e-5, atol=1e-6)
        else:
            ok = bf16_ulp_close(torch, got, ref)
            lib_ok = bf16_ulp_close(torch, got, lib.to(dt))
        if not (ok and lib_ok):
            raise AssertionError(
                f"lrn kernel disagrees at {shape} {dt} n={n}: max abs "
                f"{err:.3e} rel {rel:.3e} (plain ok={ok}, "
                f"local_response_norm ok={lib_ok})")
        max_err = max(max_err, err)
        # timed: the main paths' shapes, the ragged ones and GoogLeNet's
        if view or shape in UNTIMED_LRN_SHAPES:
            say(f"lrn {tuple(shape)} {str(dt)[6:]} n={n}"
                f"{' (view off 16-byte alignment)' if view else ''}: max "
                f"abs err {err:.3e} rel {rel:.3e}")
            continue
        bound, by = lrn_bound_ms(shape, x.element_size(), n)
        t = {
            "kernel": time_warm(torch, lambda: lrn(x, n, alpha, beta, knorm)),
            "plain": time_warm(
                torch, lambda: lrn_reference(x, n, alpha, beta, knorm)),
            "library": time_warm(torch, lambda: F.local_response_norm(
                x, n, alpha, beta, knorm)),
            "kernel_cold": time_cold(
                torch, lambda: lrn(x, n, alpha, beta, knorm), flush),
            "plain_cold": time_cold(
                torch, lambda: lrn_reference(x, n, alpha, beta, knorm), flush),
            "library_cold": time_cold(torch, lambda: F.local_response_norm(
                x, n, alpha, beta, knorm), flush),
        }
        dev = ""
        if shape in SERVE_LRN_SHAPES + TRAIN_LRN_SHAPES:
            t["kernel_device"] = lrn_device_ms(
                torch, lambda: lrn(x, n, alpha, beta, knorm),
                "lrn_fwd_kernel")
            dev = f", device time {ms_txt(t['kernel_device'])} (profiler)"
        say(f"lrn {tuple(shape)} {str(dt)[6:]} n={n}: max abs err {err:.3e} "
            f"rel {rel:.3e}; warm L2: kernel {t['kernel']:.4f} ms{dev}, "
            f"plain {t['plain']:.4f} ms, local_response_norm "
            f"{t['library']:.4f} ms; cold L2: kernel "
            f"{t['kernel_cold']:.4f} ms, plain "
            f"{t['plain_cold']:.4f} ms, local_response_norm "
            f"{t['library_cold']:.4f} ms; bound {bound:.4f} ms ({by})")
        main_rows[(shape, dt)] = dict(t, bound=bound, by=by)
    del flush
    return max_err, main_rows


def lrn_bwd_bound_ms(shape, itemsize: int, n: int):
    """Least time for one LRN backward: the larger of its bytes (x and g
    read once, gin written once) over the memory rate and its float32
    operations (about 4n + 12 per element: two window sums, the norm,
    two pows counted as 3 each, the products) over the float32 rate."""
    elems = 1
    for d in shape:
        elems *= d
    bytes_ms = 3 * elems * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = elems * (4 * n + 12) / F32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def lrn_bwd_close(torch, got, x, g, n, alpha, beta, knorm, loose=False):
    """K1-bwd against the plain version. The gradient is the difference
    of two float32 terms t1 - t2, so the bar scales with them:
    float32 rtol 1e-5 of the result + 1e-6 x (|t1| + |t2|);
    bfloat16 one bfloat16 ulp (2^-7) of the result + the same term bar
    (both sides round float32 math once; their float32 values may sit
    on either side of a rounding boundary). `loose` is the bar for the
    library yardstick, which computes the same function by another
    formula (x / (k + alpha * mean)^beta, differentiated by autograd):
    rtol 1e-3 of the result + 1e-4 x (|t1| + |t2|)."""
    from cxxnet_tpu_torch.ops.lrn import lrn_bwd_reference, lrn_bwd_terms
    ref = lrn_bwd_reference(x, g, n, alpha, beta, knorm).float()
    t1, t2 = lrn_bwd_terms(x, g, n, alpha, beta, knorm)
    rtol = 1e-5 if x.dtype == torch.float32 else 2.0 ** -7
    atol = 1e-6
    if loose:
        rtol, atol = max(rtol, 1e-3), 1e-4
    bar = rtol * ref.abs() + atol * (t1.abs() + t2.abs())
    diff = (got.detach().float() - ref).abs()
    return bool(torch.all(diff <= bar)), float(diff.max())


def phase_kernels_bwd(torch):
    import torch.nn.functional as F
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.ops.lrn import lrn, lrn_backward, lrn_bwd_reference

    say("== phase 3b: LRN backward kernel (K1-bwd) vs plain version ==")
    alpha, beta, knorm = 0.001, 0.75, 1.0
    gen = torch.Generator(device="cuda").manual_seed(4321)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    max_err = 0.0
    main_rows = {}
    cases = lrn_cases(torch, TRAIN_LRN_SHAPES, NO_SLAB_BWD)
    cases += [((2, 40, 3, 3), torch.float32, 19, False),
              ((2, 40, 3, 3), torch.bfloat16, 19, False)]
    for shape, dt, n, view in cases:
        x = lrn_input(torch, gen, shape, dt, view)
        g = lrn_input(torch, gen, shape, dt, view, scale=1.0)
        before = kernels.launches()["lrn_bwd"]
        got = lrn_backward(x, g, n, alpha, beta, knorm)
        torch.cuda.synchronize()
        if kernels.launches()["lrn_bwd"] != before + 1:
            raise AssertionError("lrn_backward did not count one launch")
        ok, err = lrn_bwd_close(torch, got, x, g, n, alpha, beta, knorm)
        # the library's gradient (autograd of F.local_response_norm) on
        # the float32-widened inputs, rounded to the working type
        xl = x.detach().float().requires_grad_(True)
        (lib,) = torch.autograd.grad(
            F.local_response_norm(xl, n, alpha, beta, knorm), xl, g.float())
        lib_ok, lib_err = lrn_bwd_close(torch, lib.to(dt), x, g, n, alpha,
                                        beta, knorm, loose=True)
        # autograd through lrn launches the same kernel: same bits
        xg = x.clone().requires_grad_(True)
        (auto,) = torch.autograd.grad(lrn(xg, n, alpha, beta, knorm), xg, g)
        same = torch.equal(auto, got)
        if not (ok and lib_ok and same):
            raise AssertionError(
                f"lrn_bwd kernel disagrees at {shape} {dt} n={n}: max abs "
                f"{err:.3e} (plain ok={ok}, local_response_norm grad "
                f"ok={lib_ok} at {lib_err:.3e}, autograd through lrn "
                f"identical={same})")
        max_err = max(max_err, err)
        if shape not in TRAIN_LRN_SHAPES:
            if view or shape in [c[0] for c in SLAB_CASES + (NO_SLAB_BWD,)]:
                say(f"lrn_bwd {tuple(shape)} {str(dt)[6:]} n={n}"
                    f"{' (view off 16-byte alignment)' if view else ''}: "
                    f"max abs err {err:.3e}; autograd through lrn "
                    "bit-identical")
            continue
        say(f"lrn_bwd {tuple(shape)} {str(dt)[6:]} n={n}: max abs err "
            f"{err:.3e} (local_response_norm backward {lib_err:.3e}); "
            "autograd through lrn bit-identical")
        bound, by = lrn_bwd_bound_ms(shape, x.element_size(), n)
        xl = x.detach().clone().requires_grad_(True)
        y = F.local_response_norm(xl, n, alpha, beta, knorm)

        def kern():
            return lrn_backward(x, g, n, alpha, beta, knorm)

        def plain():
            return lrn_bwd_reference(x, g, n, alpha, beta, knorm)

        def library():
            return torch.autograd.grad(y, xl, g, retain_graph=True)
        t = {
            "kernel": time_warm(torch, kern),
            "plain": time_warm(torch, plain),
            "library": time_warm(torch, library),
            "kernel_cold": time_cold(torch, kern, flush),
            "plain_cold": time_cold(torch, plain, flush),
            "library_cold": time_cold(torch, library, flush),
            "kernel_device": lrn_device_ms(torch, kern, "lrn_bwd_kernel"),
        }
        say(f"lrn_bwd {tuple(shape)} {str(dt)[6:]} n={n}: warm L2: kernel "
            f"{t['kernel']:.4f} ms, device time {ms_txt(t['kernel_device'])} "
            f"(profiler), plain {t['plain']:.4f} ms, "
            f"local_response_norm backward {t['library']:.4f} ms; cold L2: "
            f"kernel {t['kernel_cold']:.4f} ms, plain {t['plain_cold']:.4f} "
            f"ms, local_response_norm backward {t['library_cold']:.4f} ms; "
            f"bound {bound:.4f} ms ({by})")
        main_rows[(shape, dt)] = dict(t, bound=bound, by=by)
        del y, xl
    say(f"lrn_bwd: {len(cases)} cases agree (f32, bf16, n = 1..7, 9, 19, "
        f"41, 2501 without a slab, C = 2..8000, GoogLeNet's 56 x 56, a "
        f"view off 16-byte alignment); max abs err {max_err:.3e}")
    del flush
    return max_err, main_rows


# ---------------------------------------------------------------------------
# phase 3c: flash attention (K2-fwd, K2-dq, K2-dkv)
# ---------------------------------------------------------------------------

ATTN_FLOPS = {"attn_fwd": 4, "attn_dq": 6, "attn_dkv": 8}  # x B H Sq Sk D
ATTN_TENSORS = {"attn_fwd": 4, "attn_dq": 5, "attn_dkv": 6}  # (B,H,S,D)
ATTN_STATS = {"attn_fwd": 1, "attn_dq": 2, "attn_dkv": 2}    # (B,H,S) f32


def attn_flops(name: str, shape, causal: bool) -> float:
    """The kernel's operations on these inputs: 2 per multiply-add of
    each of its products (q.k^T, p.v; q.k^T, do.v^T, ds.k; q.k^T,
    do.v^T, p^T.do, ds^T.q). Under causal only the S(S+1)/2 visible
    score entries need them."""
    b, h, s, d = shape
    work = ATTN_FLOPS[name] * b * h * s * s * d
    return work * (s + 1) / (2 * s) if causal else work


def attn_bound_ms(name: str, shape, itemsize: int, causal: bool):
    """Least time for one launch: the larger of its bytes (q, k, v, do
    and lse/delta read once, each output written once) over the memory
    rate and its operations over the peak rate of the working type (the
    bfloat16 tensor cores; the float32 pipes for float32)."""
    b, h, s, d = shape
    nbytes = (ATTN_TENSORS[name] * b * h * s * d * itemsize
              + ATTN_STATS[name] * b * h * s * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    ops_ms = attn_flops(name, shape, causal) / peak * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def attn_close(torch, got, ref, grad=False, long=False):
    """A kernel's output against its plain version on the same inputs.
    float32: rtol 1e-5 / atol 1e-5 up to S = 257 and 1e-4 / 1e-4 at
    S = 4096 (summation order over 4096 keys); gradients rtol 1e-4 /
    atol 1e-5 (tests/test_pallas_attention.py:65). bfloat16:
    |got - ref| <= 1e-2 |ref| + 1e-2 max|ref|, inside the JAX test's
    5e-2 (:77), + 1e-5 where the true value is 0 and both sides are
    float32 cancellation noise (ds = p * (do.v - delta) with one key):
    both round p, ds and the result to bfloat16 at the same points, so
    they part where a float32 value sits on either side of a rounding
    boundary, or where the online softmax rounds p against a running
    max."""
    g, r = got.float(), ref.float()
    if ref.dtype == torch.float32:
        if grad:
            return bool(torch.allclose(g, r, rtol=1e-4, atol=1e-5))
        tol = 1e-4 if long else 1e-5
        return bool(torch.allclose(g, r, rtol=tol, atol=tol))
    bar = 1e-2 * r.abs() + 1e-2 * r.abs().max() + 1e-5
    return bool(torch.all((g - r).abs() <= bar))


def misaligned_view(torch, t):
    """A contiguous copy of t that is a view one element into its
    storage: 2-byte aligned in bfloat16, so the kernels must take their
    element load path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if t.dtype == torch.bfloat16 and view.data_ptr() % 16 == 0:
        raise AssertionError("misaligned_view is 16-byte aligned")
    return view


def time_fwd_bwd(torch, F, FA, q, k, v, do, causal, iters: int = 10):
    """ms of one forward + backward through autograd: the port's
    flash_attention (K2-fwd, K2-dq, K2-dkv and the delta reduction)
    beside scaled_dot_product_attention's (CUDA events, L2 warm)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def port():
        torch.autograd.grad(FA.flash_attention(*leaves, causal), leaves, do)

    def library():
        torch.autograd.grad(F.scaled_dot_product_attention(
            *leaves, is_causal=causal), leaves, do)

    return {"port": time_warm(torch, port, iters),
            "library": time_warm(torch, library, iters)}


# the tensor-core instances in the compiler's report: kernel name ->
# (mangled-name pattern, fields of its template arguments)
TC_INSTANCES = {
    "attn_fwd": (re.compile(r"attn_fwd_tcILi(\d+)ELb([01])ELi([12])E"),
                 ("DP", "load", "warpgroups")),
    "attn_dq": (re.compile(r"attn_dq_tcILi(\d+)ELb([01])E"),
                ("DP", "load")),
    "attn_dkv": (re.compile(r"attn_dkv_tcILi(\d+)ELb([01])E"),
                 ("DP", "load")),
    "int8_mm": (re.compile(r"int8_mm_tcILi(\d+)ELb([01])E"),
                ("BN", "load")),
}
# the SASS opcode of each library's tensor-core products: bf16 (HGMMA)
# for the attention kernels, int8 (IGMMA) for K3
TC_OPCODE = {"attn_fwd": "HGMMA", "attn_dq": "HGMMA", "attn_dkv": "HGMMA",
             "int8_mm": "IGMMA"}


def tc_smem(name: str, fields) -> str:
    """Dynamic shared memory of one tensor-core instance: K2's as its C
    entry reports it, K3's from its tile (csrc/int8_mm.cu: 4 stages of
    128 + BN rows of 128 bytes, and 1 KB of alignment slack)."""
    from cxxnet_tpu_torch.ops import flash_attention as FA
    if name == "int8_mm":
        return str(4 * (128 + fields["BN"]) * 128 + 1024)
    sq = 28 if fields.get("warpgroups") == 1 else 4096
    return str(FA.tc_plan(name, fields["DP"], sq)["smem_bytes"])


def say_tc_instances(built) -> None:
    """For every tensor-core instance of K2-fwd, K2-dq, K2-dkv (bfloat16)
    and K3 (int8): its tile parameters and load path, the dynamic shared
    memory it asks for, the registers and spills that nvcc -Xptxas -v
    reported; then the count of warpgroup tensor-core instructions
    (HGMMA / IGMMA) in each library's SASS, which must not be 0."""
    for name, (pat, keys) in TC_INSTANCES.items():
        log = built.get(name, (0.0, ""))[1]
        if log == "cached":
            say(f"{name}: library cached, no ptxas report")
            continue
        cur, spill = None, ("?", "?")
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                cur = pat.search(ln)
                spill = ("?", "?")
            elif cur is not None and "spill stores" in ln:
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", ln).groups()
            elif cur is not None and "registers" in ln:
                regs = re.search(r"Used (\d+) registers", ln).group(1)
                fields = dict(zip(keys, (int(x) for x in cur.groups())))
                path = "cp.async" if fields.pop("load") else "element"
                desc = " ".join(f"{k}={v}" for k, v in fields.items())
                say(f"{name} tensor-core instance {desc} load={path}: "
                    f"{regs} registers, spill stores {spill[0]} B, spill "
                    f"loads {spill[1]} B, dynamic shared memory "
                    f"{tc_smem(name, fields)} B")
                if spill != ("0", "0"):
                    raise AssertionError(f"{name} {desc} spills registers")
                cur = None
    from cxxnet_tpu_torch import kernels
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        say("cuobjdump not found beside nvcc: SASS not inspected")
        return
    for name, op in TC_OPCODE.items():
        sass = subprocess.run([tool, "-sass", kernels._lib_path(name)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        n = sass.count(op)
        say(f"{name}: {n} {op} instructions in the library's SASS")
        if n == 0:
            raise AssertionError(f"{name} has no {op} instruction: not on "
                                 f"the tensor cores")


def phase_attention_kernels(torch, card):
    import torch.nn.functional as F
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.ops import flash_attention as FA

    say("== phase 3c: flash attention kernels (K2-fwd, K2-dq, K2-dkv) vs "
        "plain versions ==")
    gen = torch.Generator(device="cuda").manual_seed(2468)
    names = ("attn_fwd", "attn_dq", "attn_dkv")
    max_err = {n: 0.0 for n in names}
    rows = {}
    fwd_bwd = {}
    # (q shape, dtype, causal, scale, Sk (None: Sq), misaligned view)
    cases = [(SEQ_ATTN_SHAPE, dt, False, None, None, False)
             for dt in (torch.bfloat16, torch.float32)]
    for s in (1, 12, 28, 33, 100, 257):
        for d, h in ((7, 3), (8, 1), (16, 3), (64, 1), (96, 3), (128, 1),
                     (256, 3)):
            if s * d * h > 100 * 256:
                continue  # the ragged set stays small
            causal = (s + d) % 2 == 1
            scale = 0.3 if d == 16 else None
            for dt in (torch.float32, torch.bfloat16):
                cases.append(((2, h, s, d), dt, causal, scale, None, False))
    cases += [((1, 1, 257, 256), torch.bfloat16, True, None, None, False),
              ((1, 1, 257, 256), torch.float32, False, 0.05, None, False)]
    # the tensor-core instances' other edges: head_dim 12 and 200 (not
    # multiples of 8 / 16), Sq != Sk under both masks, and contiguous
    # views whose storage offset breaks 16-byte alignment
    for c in (False, True):
        cases += [((2, 3, 100, 12), torch.bfloat16, c, None, None, False),
                  ((1, 2, 257, 200), torch.bfloat16, c, None, None, False),
                  ((1, 2, 100, 64), torch.bfloat16, c, None, 257, False),
                  ((1, 2, 100, 64), torch.float32, c, None, 257, False),
                  ((1, 2, 257, 128), torch.bfloat16, c, None, None, True),
                  ((2, 3, 33, 7), torch.bfloat16, c, None, None, True)]
    cases += [(MEASURE_ATTN_SHAPE, torch.bfloat16, c, None, None, False)
              for c in (False, True)]
    cases.append((MEASURE_ATTN_SHAPE, torch.float32, False, None, None,
                  False))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for shape, dt, causal, scale, sk, misaligned in cases:
        kshape = shape[:2] + (sk or shape[2], shape[3])
        q, k, v, do = (torch.randn(sh, generator=gen, device="cuda").to(dt)
                       for sh in (shape, kshape, kshape, shape))
        if misaligned:
            q, k, v, do = (misaligned_view(torch, t) for t in (q, k, v, do))
        before = kernels.launches()
        o, lse = FA.attn_fwd(q, k, v, causal, scale)
        delta = FA.flash_delta(o, do)
        dq = FA.attn_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = FA.attn_dkv(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        after = kernels.launches()
        if any(after[n] != before[n] + 1 for n in names):
            raise AssertionError("each K2 wrapper must count one launch "
                                 "per call")
        # no atomics: a second launch of each kernel gives the same bits
        o2, lse2 = FA.attn_fwd(q, k, v, causal, scale)
        dk2, dv2 = FA.attn_dkv(q, k, v, do, lse, delta, causal, scale)
        if not (torch.equal(o2, o) and torch.equal(lse2, lse)
                and torch.equal(FA.attn_dq(q, k, v, do, lse, delta, causal,
                                           scale), dq)
                and torch.equal(dk2, dk) and torch.equal(dv2, dv)):
            raise AssertionError(f"K2 is not bitwise repeatable at {shape} "
                                 f"{dt}")
        del o2, lse2, dk2, dv2
        ro, rlse = FA.flash_fwd_reference(q, k, v, causal, scale)
        rdq = FA.flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
        rdk, rdv = FA.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                          scale)
        long = shape[2] > 257
        checks = {"attn_fwd": [("o", o, ro, False), ("lse", lse, rlse,
                                                       False)],
                  "attn_dq": [("dq", dq, rdq, True)],
                  "attn_dkv": [("dk", dk, rdk, True), ("dv", dv, rdv, True)]}
        errs = {}
        for n, outs in checks.items():
            for what, got, ref, grad in outs:
                err = float((got.float() - ref.float()).abs().max())
                errs[what] = err
                if not attn_close(torch, got, ref, grad, long):
                    raise AssertionError(
                        f"{n} disagrees with its plain version at {shape} "
                        f"Sk={sk} misaligned={misaligned} {dt} "
                        f"causal={causal} scale={scale}: {what} max "
                        f"abs {err:.3e} (max |ref| "
                        f"{float(ref.float().abs().max()):.3e})")
                max_err[n] = max(max_err[n], err)
        del ro, rlse, rdq, rdk, rdv
        timed = (shape in (SEQ_ATTN_SHAPE, MEASURE_ATTN_SHAPE)
                 and dt == torch.bfloat16)
        if shape == MEASURE_ATTN_SHAPE and dt == torch.bfloat16:
            fwd_bwd[causal] = time_fwd_bwd(torch, F, FA, q, k, v, do,
                                           causal)
        if not timed:
            continue
        say(f"{shape} bf16 causal={causal}: max abs err " + ", ".join(
            f"{w} {e:.3e}" for w, e in errs.items()) + "; K2-fwd plan "
            + str(FA.tc_plan("attn_fwd", shape[3], shape[2])))
        # the library yardstick: one scaled_dot_product_attention call
        # and its backward on the same inputs (never on the port's path)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl,
                                                 is_causal=causal,
                                                 scale=scale)
        fns = {
            "attn_fwd": (lambda: FA.attn_fwd(q, k, v, causal, scale),
                         lambda: FA.flash_fwd_reference(q, k, v, causal,
                                                        scale),
                         lambda: F.scaled_dot_product_attention(
                             q, k, v, is_causal=causal, scale=scale)),
            "attn_dq": (lambda: FA.attn_dq(q, k, v, do, lse, delta, causal,
                                           scale),
                        lambda: FA.flash_dq_reference(q, k, v, do, lse, delta,
                                                      causal, scale),
                        lambda: torch.autograd.grad(
                            lib_out, (ql, kl, vl), do, retain_graph=True)),
            "attn_dkv": (lambda: FA.attn_dkv(q, k, v, do, lse, delta,
                                             causal, scale),
                         lambda: FA.flash_dkv_reference(q, k, v, do, lse,
                                                        delta, causal, scale),
                         None),
        }
        iters = 10 if shape == MEASURE_ATTN_SHAPE else 50
        for n, (kern, plain, lib) in fns.items():
            bound, by = attn_bound_ms(n, shape, q.element_size(), causal)
            t = {"kernel": time_warm(torch, kern, iters),
                 "kernel_cold": time_cold(torch, kern, flush, 10),
                 "plain": time_warm(torch, plain, 5 if iters == 10 else 20),
                 "bound": bound, "by": by,
                 "flops": attn_flops(n, shape, causal)}
            if lib is not None:
                t["library"] = time_warm(torch, lib, iters)
            tflops = t["flops"] / t["kernel"] / 1e9
            lib_txt = (f", library {t['library']:.4f} ms" if lib is not None
                       else "")
            say(f"{n} {shape} bf16 causal={causal}: kernel {t['kernel']:.4f}"
                f" ms ({tflops:.2f} TFLOP/s), L2 cold {t['kernel_cold']:.4f}"
                f" ms, plain {t['plain']:.4f} ms{lib_txt}; bound "
                f"{bound:.4f} ms ({by}) on {card}")
            rows[(n, shape, causal)] = t
        del ql, kl, vl, lib_out
    # the library's backward computes dq, dk and dv in one call: it
    # stands beside K2-dq + K2-dkv together
    for key in list(rows):
        n, shape, causal = key
        if n == "attn_dkv":
            rows[key]["library"] = rows[("attn_dq", shape, causal)][
                "library"]
    del flush
    say(f"attention kernels: {len(cases)} cases agree and K2-fwd / K2-dq "
        f"/ K2-dkv repeat bitwise (f32, bf16; S = 1, 12, 28, 33, 100, 257, "
        f"4096; D = 7 .. 256 incl. 12, 200; Sq != Sk; 2-byte-aligned views; "
        f"causal and not); max abs err "
        + ", ".join(f"{n} {e:.3e}" for n, e in max_err.items()))
    for causal in (False, True):
        m = MEASURE_ATTN_SHAPE
        pair = rows[("attn_dq", m, causal)]["kernel"] + rows[
            ("attn_dkv", m, causal)]["kernel"]
        lib_bwd = rows[("attn_dq", m, causal)]["library"]
        flops = (attn_flops("attn_dq", m, causal)
                 + attn_flops("attn_dkv", m, causal))
        say(f"K2-dq + K2-dkv {m} bf16 causal={causal}: {pair:.4f} ms "
            f"({flops / pair / 1e9:.2f} TFLOP/s) = "
            f"{pair / lib_bwd:.3f} x the backward of "
            f"scaled_dot_product_attention ({lib_bwd:.4f} ms) on {card}")
        fb = fwd_bwd[causal]
        say(f"flash_attention forward+backward (autograd) {m} bf16 "
            f"causal={causal}: {fb['port']:.4f} ms; "
            f"scaled_dot_product_attention forward+backward "
            f"{fb['library']:.4f} ms ({fb['port'] / fb['library']:.3f} x) "
            f"on {card}")
        rows[("attn_dkv", m, causal)]["fwd_bwd"] = fb
    return max_err, rows


# ---------------------------------------------------------------------------
# phase 4: AlexNet serving at full width
# ---------------------------------------------------------------------------

def conf_trainer(conf, overrides):
    """A trainer as the CLI builds it from `conf`: the file unmodified,
    its iterator blocks split off (their files are never opened), the
    device from `dev` (the shipped files say tpu: cuda:0)."""
    from cxxnet_tpu_torch.main import LearnTask
    task = LearnTask()
    task.load_conf(conf, ["seed=7", "silent=1"] + list(overrides))
    tr = task.create_net()
    tr.init_model()
    return tr


def alexnet_trainer(overrides):
    return conf_trainer(os.path.join(REPO, "examples", "ImageNet",
                                     "AlexNet.conf"), overrides)


def staging_ms(torch, tr, stage, n: int):
    """Host-clock ms of one synchronised `stage()` under each
    stage_dtype: "" (bfloat16 here: cast on the host, half the bytes
    across - the default) and "float32" (float32 across, cast on the
    card)."""
    out, keep = {}, tr.stage_dtype
    for sd in ("", "float32"):
        tr.stage_dtype = sd
        stage()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            stage()
        torch.cuda.synchronize()
        out[sd or "bfloat16"] = (time.perf_counter() - t1) / n * 1e3
    tr.stage_dtype = keep
    return out


def stage_txt(stage) -> str:
    return (f"{stage['bfloat16']:.3f} ms (host clock; cast on the host, "
            f"the default) or {stage['float32']:.3f} ms (stage_dtype = "
            f"float32: cast on the card)")


# Phase 4's bfloat16 bar for served rows against predict_dist of the same
# rows: bfloat16 forwards whose cuDNN/cuBLAS algorithms may differ per
# bucket size, so rows agree to bfloat16 rounding, not bitwise. One bf16
# ulp of a logit in [8, 16) is 2^-4, which moves its probability by up
# to 6.5%: rtol 0.1 allows that much, atol covers probabilities near 0
BF16_RTOL, BF16_ATOL = 0.1, 2e-4


def check_bf16_rows(tr, reqs, results, ref_rows=None):
    """Every served row against predict_dist of its request (or against
    `ref_rows`, the same list precomputed) at the bfloat16 bar, and the
    argmax wherever the reference's top-2 margin is wider than the two
    entries can move within the bar (a narrower margin is a tie at it).
    Returns (max abs, max rel where p >= 1e-3, undecided rows, rows
    whose argmax differs in all); raises on a miss."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    rtol, atol = BF16_RTOL, BF16_ATOL
    worst = worst_rel = 0.0
    undecided = flipped = 0
    for i, (data, got) in enumerate(zip(reqs, results)):
        ref = (ref_rows[i] if ref_rows is not None else tr.predict_dist(
            DataBatch(data=data,
                      label=np.zeros((data.shape[0], 1), np.float32))))
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"served rows {got.shape} vs {ref.shape}")
        worst = max(worst, float(np.abs(got - ref).max()))
        big = ref >= 1e-3  # the top class of a 1000-way softmax always is
        worst_rel = max(worst_rel, float(
            (np.abs(got - ref)[big] / ref[big]).max()))
        if not np.allclose(got, ref, rtol=rtol, atol=atol):
            raise AssertionError(
                f"served rows differ from predict_dist: max abs "
                f"{np.abs(got - ref).max():.3e} > rtol {rtol} atol {atol}")
        top2 = np.sort(ref, axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * (atol + rtol * top2[:, 1])
        undecided += int((~decided).sum())
        flipped += int((got.argmax(1) != ref.argmax(1)).sum())
        if not np.array_equal(got.argmax(1)[decided],
                              ref.argmax(1)[decided]):
            raise AssertionError("served argmax differs from predict")
    return worst, worst_rel, undecided, flipped


def phase_serving(torch, card):
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.serve import Server

    say("== phase 4: AlexNet (examples/ImageNet/AlexNet.conf) served at "
        "full width ==")
    tr = alexnet_trainer([])
    if tr.compute_dtype != torch.bfloat16 or str(tr.device) != "cuda:0":
        raise AssertionError(f"AlexNet.conf should run bfloat16 on "
                             f"cuda:0, got {tr.compute_dtype} on "
                             f"{tr.device}")
    srv = Server(tr, max_batch=64)
    say(f"buckets {list(srv.buckets)}; warmup {srv.warmup():.3f} s")
    rng = np.random.RandomState(11)
    sizes = [int(s) for s in rng.randint(1, 65, size=30)]
    sizes[0], sizes[1] = 64, 1
    reqs = [(rng.rand(s, 3, 227, 227) * 255.0 - 128.0).astype(np.float32)
            for s in sizes]
    results = [None] * len(reqs)
    errors = []

    def client(idx):
        try:
            futs = [(i, srv.submit(reqs[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(timeout=300)
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    kernels.reset_launches()
    srv.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(k, len(reqs),
                                                          2),))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    stats = srv.stop()
    launches = kernels.launches()["lrn_fwd"]
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(r is None
                                                 for r in results):
        raise AssertionError("a serve request never resolved")
    if launches != 2 * stats["batches"] or stats["batches"] == 0:
        raise AssertionError(
            f"lrn_fwd launched {launches} times over {stats['batches']} "
            "dispatched batches; AlexNet runs it twice per batch")
    rows = sum(sizes)
    say(f"served {len(reqs)} requests, {rows} rows in {stats['batches']} "
        f"batches ({stats['padding_rows']} padding rows); lrn_fwd "
        f"launches {launches} = 2 per batch")
    say(f"latency p50 {stats['latency_p50_ms']} ms, p99 "
        f"{stats['latency_p99_ms']} ms (queue p50 "
        f"{stats['queue_p50_ms']} ms, device p50 "
        f"{stats['device_p50_ms']} ms), {rows / wall:.1f} rows/s "
        f"({len(reqs)} requests from 2 threads, max_batch 64, bfloat16) "
        f"on {card}")
    served = dict(stats, rows_per_s=rows / wall)

    # where a full bucket's time goes: host staging against the forward
    # alone, each synchronised
    full = reqs[0][:64]
    stage = staging_ms(torch, tr, lambda: tr.stage_infer_rows(full), 10)
    staged = tr.stage_infer_rows(full)
    fwd_ms = time_warm(torch, lambda: tr.infer_rows(staged), iters=10)
    say(f"full bucket of 64: staging {stage_txt(stage)}, forward "
        f"{fwd_ms:.3f} ms (CUDA events, {64 / fwd_ms * 1e3:.0f} rows/s "
        f"device-only) on {card}")
    served["forward_ms"] = fwd_ms

    rtol, atol = BF16_RTOL, BF16_ATOL
    worst, worst_rel, undecided, flipped = check_bf16_rows(tr, reqs,
                                                           results)
    say(f"served vs predict_dist: max abs {worst:.3e}, max rel "
        f"{worst_rel:.3e} where p >= 1e-3 (rtol {rtol}, atol "
        f"{atol}); argmax identical on {rows - undecided}/{rows} rows "
        f"({undecided} within the tolerance of a tie; {flipped} rows' "
        f"argmax differ in all)")
    if undecided * 4 > rows * 3:
        raise AssertionError("too few decided rows for the argmax check")
    del tr, srv
    torch.cuda.empty_cache()

    # float32 leg: the same rows on the card (TF32 off) and through the
    # port on the CPU (plain versions), same seed -> same weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows4 = reqs[0][:4]
    batch = DataBatch(data=rows4, label=np.zeros((4, 1), np.float32))
    gpu = alexnet_trainer(["dtype=float32"]).predict_dist(batch)
    cpu = alexnet_trainer(["dtype=float32", "dev=cpu"]).predict_dist(batch)
    f_rtol, f_atol = 1e-3, 1e-6
    diff = float(np.abs(gpu - cpu).max())
    if not (np.allclose(gpu, cpu, rtol=f_rtol, atol=f_atol)
            and np.array_equal(gpu.argmax(1), cpu.argmax(1))):
        raise AssertionError(
            f"float32 card vs CPU: max abs {diff:.3e} > rtol {f_rtol} atol "
            f"{f_atol}, or argmax differs")
    say(f"float32 (TF32 off) card vs CPU on 4 rows: max abs {diff:.3e} "
        f"(rtol {f_rtol}, atol {f_atol}), argmax equal")
    return launches, served


# ---------------------------------------------------------------------------
# phase 5: the CLI on the default device
# ---------------------------------------------------------------------------

CLI_CONF = """
pred = {out}
iter = mnist
  path_img = "{d}/t10k-images-idx3-ubyte.gz"
  path_label = "{d}/t10k-labels-idx1-ubyte.gz"
  input_flat = 0
iter = end

netconfig=start
layer[0->1] = conv:c1
  kernel_size = 5
  stride = 2
  nchannel = 16
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 10
layer[6->6] = softmax
netconfig=end
input_shape = 1,28,28
batch_size = 50
random_type = xavier
seed = 5
silent = 1
"""


def write_mnist(d: str, n: int, seed: int, prefix: str = "t10k",
                noise: float = 40.0, gain: float = 120.0) -> None:
    """A synthetic MNIST-format dataset: gaussian noise around 100 plus a
    class-dependent bright block."""
    import numpy as np
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = np.clip(rng.randn(n, 28, 28) * noise + 100, 0, 255)
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 5)
        images[i, r * 10 + 2:r * 10 + 10, c * 5 + 1:c * 5 + 6] += gain
    images = np.clip(images, 0, 255).astype(np.uint8)
    with gzip.open(f"{d}/{prefix}-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28))
        f.write(images.tobytes())
    with gzip.open(f"{d}/{prefix}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())


def phase_cli():
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    say("== phase 5: CLI task=pred vs task=serve on the default device ==")
    with tempfile.TemporaryDirectory() as d:
        write_mnist(d, 500, 4)
        conf = os.path.join(d, "net.conf")
        with open(conf, "w") as f:
            f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d))
        tr = NetTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d))
        tr.init_model()
        model = os.path.join(d, "0001.model")
        with open(model, "wb") as fo:
            tr.save_model(fo)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        outs = {}
        for task in ("pred", "serve"):
            out = os.path.join(d, f"{task}.txt")
            proc = subprocess.run(
                [sys.executable, "-m", "cxxnet_tpu_torch.main", conf,
                 f"task={task}", f"model_in={model}", f"pred={out}",
                 "serve_rows=0"],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                raise AssertionError(
                    f"task={task} exited {proc.returncode}:\n"
                    f"{proc.stdout}{proc.stderr}")
            with open(out) as f:
                outs[task] = f.read()
            if task == "serve":
                m = re.search(r"kernel launches (\{.*\})", proc.stdout)
                if not m or ast.literal_eval(m.group(1))["lrn_fwd"] == 0:
                    raise AssertionError(
                        f"served run launched no lrn kernel:\n"
                        f"{proc.stdout}")
                say("task=serve child: " + next(
                    ln for ln in proc.stdout.splitlines()
                    if "kernel launches" in ln))
        n_lines = outs["pred"].count("\n")
        if outs["pred"] != outs["serve"] or n_lines != 500:
            raise AssertionError(
                f"task=serve output differs from task=pred "
                f"({n_lines} pred lines)")
        say(f"task=pred and task=serve outputs identical ({n_lines} lines, "
            f"{len(set(outs['pred'].split()))} distinct classes)")


# ---------------------------------------------------------------------------
# phase 6: AlexNet training at full width
# ---------------------------------------------------------------------------

def numpy_keep(tr, seed: int):
    """Dropout masks for every dropout layer of `tr`'s net, from numpy:
    what update(keep=...) injects so two devices train alike."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = {}
    for idx, info in enumerate(tr.net_cfg.layers):
        if info.type_name == "dropout":
            shape = tr.net.node_shapes[info.nindex_in[0]]
            out[idx] = rng.rand(*shape) < 1.0 - tr.net.layer_objs[
                idx].threshold
    return out


def softmax_ce(tr, batch) -> float:
    """Mean cross-entropy of the batch's labels under predict_dist
    (inference: dropout off)."""
    import numpy as np
    p = tr.predict_dist(batch)
    picked = p[np.arange(p.shape[0]), batch.label[:, 0].astype(int)]
    return float(-np.mean(np.log(np.maximum(picked, 1e-30))))


# named groups of a profile: (label, kind, name) - kind "kernel" sums
# device kernels whose name contains `name`, "range" the record_function
# ranges so named, "op" the device time under the aten op `name`
ALEXNET_GROUPS = (
    ("lrn_fwd kernel", "kernel", "lrn_fwd_kernel"),
    ("lrn_bwd kernel", "kernel", "lrn_bwd_kernel"),
    ("max-pool ties backward", "range", "max_pool_ties_backward"),
    ("convolutions (fwd+bwd)", "op", "aten::cudnn_convolution"),
    ("convolutions (fwd+bwd)", "op", "aten::convolution_backward"),
)
# "attn_dq_" matches both instances of K2-dq (attn_dq_kernel, float32;
# attn_dq_tc, bfloat16 on the tensor cores), and so on
SEQ_GROUPS = (
    ("attn_fwd kernel", "kernel", "attn_fwd_"),
    ("attn_dq kernel", "kernel", "attn_dq_"),
    ("attn_dkv kernel", "kernel", "attn_dkv_"),
)


INT8_GROUPS = (
    ("int8_mm kernel", "kernel", "int8_mm_"),
    ("lrn_fwd kernel", "kernel", "lrn_fwd_kernel"),
    ("im2col unfold", "op", "aten::im2col"),
)


class ProfilerLost(RuntimeError):
    """A torch.profiler trace holds no kernel event although the traced
    calls launched kernels."""


def profile_steps(torch, step, n_steps: int, group_spec=ALEXNET_GROUPS,
                  strict: bool = False):
    """torch.profiler over `n_steps` calls of `step`: the ten CUDA
    entries with the most self device time, the named groups of
    `group_spec` and the device's idle share of the traced window
    (1 - union of kernel, memcpy and memset intervals / window from the
    first event to the last). A trace without kernel events is "not
    measured" (zeros), or raises ProfilerLost where `strict`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, lo, hi = [], float("inf"), 0.0
    n_kernels = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ts, ts + dur))
            n_kernels += e.get("cat") == "kernel"
    if n_kernels == 0:
        # the trace holds no kernel at all although the steps launched
        # some: the profiler lost the card's activity (it happens in a
        # long-lived process - PERF.md §7); nothing of this session is a
        # measurement
        if strict:
            raise ProfilerLost("profiler: the trace holds no kernel "
                               "events")
        say("profiler: the trace holds no kernel events (not measured)")
        return [], {label: 0.0 for label, _, _ in group_spec}, 0.0, 0.0
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window_ms = (hi - lo) / 1e3 if hi > lo else 0.0
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3 / n_steps, ev.count // n_steps, ev.key))
    rows.sort(reverse=True)
    groups = {label: 0.0 for label, _, _ in group_spec}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        dur = float(e["dur"]) / 1e3 / n_steps
        for label, kind, want in group_spec:
            if (kind == "kernel" and e.get("cat") == "kernel"
                    and want in name) or (
                    kind == "range" and name == want
                    and e.get("cat") == "gpu_user_annotation"):
                groups[label] += dur
    for ev in prof.key_averages():
        for label, kind, want in group_spec:
            if kind == "op" and ev.key == want:
                dev = getattr(ev, "device_time_total", None)
                if dev is None:
                    dev = getattr(ev, "cuda_time_total", 0.0)
                groups[label] += dev / 1e3 / n_steps
    return rows[:10], groups, busy / 1e3, window_ms


def say_profile(profiled, n_steps: int, card: str) -> None:
    rows, groups, busy_ms, window_ms = profiled
    if not rows:
        say("profiler: no device time in key_averages() (not measured)")
        return
    say(f"profiler, {n_steps} steps: top 10 CUDA entries by self device "
        "time (ms per step, calls per step, name)")
    for ms, calls, name in rows:
        say(f"  {ms:9.3f} ms  {calls:5d}  {name[:110]}")
    for name, ms in groups.items():
        say(f"  group {name}: {ms:.3f} ms per step")
    say(f"device busy {busy_ms / n_steps:.3f} ms of {window_ms / n_steps:.3f}"
        f" ms per step in the traced window: idle share "
        f"{1 - busy_ms / window_ms:.4f} on {card}")


def train_steps(torch, tr, batch, per_step, timed=10, staged=None):
    """2 warm-up and `timed` timed steps of tr.update (on `staged`, a
    StagedBatch of `batch`, where given) with the launch counts set to 0
    just before and read just after. Raises unless every loss is finite,
    each kernel launched `per_step[name]` times per step (0 for the
    others), every param moved and the repeated batch was fitted
    (softmax cross-entropy under predict_dist fell). Returns (counts,
    step ms on the host clock, peak device memory in bytes)."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    src = batch if staged is None else staged
    total = 2 + timed
    ce_before = softmax_ce(tr, batch)
    start = {k: {n: t.clone() for n, t in d.items()}
             for k, d in tr.state["params"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = [tr.update(src) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(tr.update(src))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    loss_vals = [float(v) for v in losses]
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"non-finite training loss: {loss_vals}")
    want = {n: total * per_step.get(n, 0) for n in counts}
    if counts != want:
        raise AssertionError(f"{total} steps launched {counts}, expected "
                             f"{want}")
    unmoved = [f"{k}/{n}" for k, d in tr.state["params"].items()
               for n, t in d.items() if torch.equal(t, start[k][n])]
    if unmoved:
        raise AssertionError(f"params unchanged by {total} steps: "
                             f"{unmoved}")
    del start
    ce_after = softmax_ce(tr, batch)
    if not ce_after < ce_before:
        raise AssertionError(f"the repeated batch was not fitted: "
                             f"cross-entropy {ce_before:.4f} -> "
                             f"{ce_after:.4f}")
    say(f"{total} steps (2 warm-up + {timed} timed), losses "
        f"{loss_vals[0]:.4f} .. "
        f"{loss_vals[-1]:.4f}, all finite; launches "
        f"{ {n: c for n, c in counts.items() if c} } = {per_step} per "
        "step; every param moved")
    say(f"repeated batch, predict_dist (dropout off): cross-entropy "
        f"{ce_before:.4f} before -> {ce_after:.4f} after the steps")
    return counts, step_ms, peak


def f32_step_card_vs_cpu(torch, make_trainer, images, labels, per_step):
    """One float32 step at batch 8 on the card (TF32 off, `per_step`
    kernel launches) and through the port on the CPU, from the same
    weights (seed), batch and dropout masks. The CPU leg replays the
    card's discrete decisions (ops/routing.py: max-pool tie sets, relu
    gates): a value within float32 rounding of a decision boundary falls
    on either side by summation order, and one such decision moves
    ~1e-3 of an early tensor's update; the count of those the CPU would
    have made the other way is printed. Then the loss within rtol 1e-4,
    the updated params within rtol 1e-3 / atol 1e-5, and each tensor's
    update within UPDATE_BAR of the CPU's in relative norm,
    ||d_card - d_cpu|| / ||d_cpu|| (a 1% fault in any layer's update
    would exceed it)."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.ops.routing import Routing
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, loss_rtol = 8, 1e-4
    small = DataBatch(data=images[:rows], label=labels[:rows])
    legs, routing = {}, None
    for dev in ("gpu", "cpu"):
        t = make_trainer(["dtype=float32", f"batch_size={rows}"]
                         + (["dev=cpu"] if dev == "cpu" else []))
        before = {k: {n: v.cpu().numpy().copy() for n, v in d.items()}
                  for k, d in t.state["params"].items()}
        routing = Routing(replay=routing)
        kernels.reset_launches()
        with routing:
            loss = float(t.update(small, keep=numpy_keep(t, seed=12)))
        counts = kernels.launches()
        if dev == "gpu" and counts != {n: per_step.get(n, 0)
                                       for n in counts}:
            raise AssertionError(f"float32 step launched {counts}")
        after = {k: {n: v.cpu().numpy() for n, v in d.items()}
                 for k, d in t.state["params"].items()}
        legs[dev] = (loss, before, after)
        del t
    f_rtol, f_atol = 1e-3, 1e-5
    (lg, bg, ag), (lc, bc, ac) = legs["gpu"], legs["cpu"]
    worst, worst_delta, worst_key = 0.0, 0.0, ""
    for k in ac:
        for n in ac[k]:
            if not np.array_equal(bg[k][n], bc[k][n]):
                raise AssertionError(f"{k}/{n}: the two legs started from "
                                     "different weights")
            if not np.allclose(ag[k][n], ac[k][n], rtol=f_rtol, atol=f_atol):
                raise AssertionError(
                    f"float32 step, card vs CPU: {k}/{n} max abs "
                    f"{np.abs(ag[k][n] - ac[k][n]).max():.3e} > rtol "
                    f"{f_rtol} atol {f_atol}")
            worst = max(worst, float(np.abs(ag[k][n] - ac[k][n]).max()))
            dg, dc = ag[k][n] - bg[k][n], ac[k][n] - bc[k][n]
            den = float(np.linalg.norm(dc))
            rel = float(np.linalg.norm(dg - dc)) / den if den else float(
                np.linalg.norm(dg) > 0)
            if rel > worst_delta:
                worst_delta, worst_key = rel, f"{k}/{n}"
    if not np.isclose(lg, lc, rtol=loss_rtol):
        raise AssertionError(f"float32 step loss: card {lg} vs CPU {lc}")
    if worst_delta > UPDATE_BAR:
        raise AssertionError(
            f"float32 step, card vs CPU: the update of {worst_key} differs "
            f"by {worst_delta:.3e} of its norm > {UPDATE_BAR}")
    say(f"float32 (TF32 off) step at batch {rows}, card vs CPU, same "
        f"masks: loss {lg:.6f} vs {lc:.6f} (rtol {loss_rtol}); updated "
        f"params max abs diff {worst:.3e} (rtol {f_rtol}, atol {f_atol}); "
        f"the worst tensor's update ({worst_key or '-'}) differs by "
        f"{worst_delta:.3e} of its norm (bar {UPDATE_BAR}); decisions "
        f"replayed from the card, those the CPU would have made the other "
        f"way: " + ", ".join(f"{k} {routing.differ[k]} of "
                             f"{routing.total[k]}" for k in routing.total))


def phase_training(torch, card):
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch

    say("== phase 6: AlexNet (examples/ImageNet/AlexNet.conf) trained at "
        "full width ==")
    tr = alexnet_trainer([])
    if (tr.compute_dtype != torch.bfloat16 or str(tr.device) != "cuda:0"
            or tr.batch_size != 256):
        raise AssertionError(f"AlexNet.conf should train b256 bfloat16 on "
                             f"cuda:0, got b{tr.batch_size} "
                             f"{tr.compute_dtype} on {tr.device}")
    rng = np.random.RandomState(11)
    images = (rng.rand(256, 3, 227, 227) * 255.0 - 128.0).astype(np.float32)
    labels = rng.randint(0, 1000, size=(256, 1)).astype(np.float32)
    batch = DataBatch(data=images, label=labels)
    per_step = {"lrn_fwd": 2, "lrn_bwd": 2}
    counts, step_ms, peak = train_steps(torch, tr, batch, per_step)
    stage = staging_ms(torch, tr, lambda: tr._stage(batch, train=True), 3)
    say(f"AlexNet b256 bfloat16 training step: {step_ms:.3f} ms "
        f"(host clock over 10 steps, CUDA-synchronised), "
        f"{256 / step_ms * 1e3:.1f} images/s; of which staging the batch "
        f"{stage_txt(stage)}; peak memory {peak / 2 ** 30:.3f} GiB; on "
        f"{card}")
    say_profile(profile_steps(torch, lambda: tr.update(batch), 3), 3, card)
    del tr
    torch.cuda.empty_cache()
    f32_step_card_vs_cpu(torch, alexnet_trainer, images, labels, per_step)
    return counts


# ---------------------------------------------------------------------------
# phase 7: CLI training on the default device
# ---------------------------------------------------------------------------

TRAIN_CONF = """
data = train
iter = mnist
  path_img = "{d}/train-images-idx3-ubyte.gz"
  path_label = "{d}/train-labels-idx1-ubyte.gz"
  input_flat = 0
  shuffle = 1
iter = end
eval = test
iter = mnist
  path_img = "{d}/t10k-images-idx3-ubyte.gz"
  path_label = "{d}/t10k-labels-idx1-ubyte.gz"
  input_flat = 0
iter = end
pred = {d}/pred.txt
iter = mnist
  path_img = "{d}/t10k-images-idx3-ubyte.gz"
  path_label = "{d}/t10k-labels-idx1-ubyte.gz"
  input_flat = 0
iter = end
""" + CLI_CONF.split("iter = end", 1)[1] + """
eta = {eta}
momentum = 0.9
wd = 0.0001
metric = error
num_round = 3
save_model = 1
model_dir = {d}/models
"""


def run_cli(args, dev_args=(), expect_ok=True, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.main"] + list(args)
        + list(dev_args), cwd=cwd, env=env, capture_output=True, text=True,
        timeout=600)
    if expect_ok and proc.returncode != 0:
        raise AssertionError(f"{args[1:]} exited {proc.returncode}:\n"
                             f"{proc.stdout}{proc.stderr}")
    return proc


def round_errors(stderr: str):
    """{round: test-error} from the per-round `[N]\t...` lines."""
    out = {}
    for ln in stderr.splitlines():
        m = re.match(r"\[(\d+)\].*\ttest-error:([0-9.e+-]+|nan)", ln)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def phase_cli_train(dev_args=(), n_train=1000, eta=0.01):
    say("== phase 7: CLI task=train / continue / pred on the default "
        "device ==")
    with tempfile.TemporaryDirectory() as d:
        write_mnist(d, n_train, 3, "train")
        write_mnist(d, 500, 4, "t10k")
        conf = os.path.join(d, "train.conf")
        with open(conf, "w") as f:
            f.write(TRAIN_CONF.format(d=d, eta=eta))
        proc = run_cli([conf, "silent=0"], dev_args)
        errs = round_errors(proc.stderr)
        m = re.search(r"kernel launches (\{.*\})", proc.stdout)
        counts = ast.literal_eval(m.group(1)) if m else {}
        say("task=train child: " + " | ".join(
            ln for ln in proc.stderr.splitlines() if ln.startswith("[")))
        say(f"task=train child: kernel launches {counts}")
        e = [errs.get(r) for r in (1, 2, 3)]
        if None in e or not (e[2] < e[0] and e[2] <= e[1] and e[2] < 0.2):
            raise AssertionError(f"test-error per round {e}: should fall "
                                 f"and end under 0.2\n{proc.stderr}")
        if not os.path.exists(os.path.join(d, "models", "0003.model")):
            raise AssertionError("models/0003.model was not written")
        if counts.get("lrn_bwd", 0) <= 0 or counts.get("lrn_fwd", 0) <= 0:
            raise AssertionError(f"CLI training launched {counts}")
        proc = run_cli([conf, "continue=1", "num_round=4"], dev_args)
        errs = round_errors(proc.stderr)
        if sorted(errs) != [4] or not os.path.exists(
                os.path.join(d, "models", "0004.model")):
            raise AssertionError(f"continue=1 should train round 4 only:\n"
                                 f"{proc.stdout}{proc.stderr}")
        say(f"continue=1 num_round=4: resumed, round 4 test-error "
            f"{errs[4]:g}, models/0004.model written")
        proc = run_cli([conf, "continue=1", f"model_dir={d}/empty"],
                       dev_args, expect_ok=False)
        if proc.returncode == 0:
            raise AssertionError("continue=1 with an empty model_dir "
                                 "exited 0")
        say(f"continue=1 with an empty model_dir: exit {proc.returncode}")
        run_cli([conf, "task=pred", f"model_in={d}/models/0004.model"],
                dev_args)
        with open(os.path.join(d, "pred.txt")) as f:
            preds = f.read().split()
        if len(preds) != 500:
            raise AssertionError(f"task=pred wrote {len(preds)} lines")
        say(f"task=pred: {len(preds)} lines, one per test image")
        return e


# ---------------------------------------------------------------------------
# phase 8: the sequence family (examples/LongSeq/seq_mnist.conf)
# ---------------------------------------------------------------------------

SEQ_CONF = os.path.join(REPO, "examples", "LongSeq", "seq_mnist.conf")
K2 = ("attn_fwd", "attn_dq", "attn_dkv")


def seq_trainer(overrides):
    return conf_trainer(SEQ_CONF, overrides)


def phase_seq_training(torch, card):
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch

    say("== phase 8a: examples/LongSeq/seq_mnist.conf trained on the card "
        "==")
    tr = seq_trainer([])
    if (tr.compute_dtype != torch.bfloat16 or str(tr.device) != "cuda:0"
            or tr.batch_size != 100):
        raise AssertionError(f"seq_mnist.conf should train b100 bfloat16 "
                             f"on cuda:0, got b{tr.batch_size} "
                             f"{tr.compute_dtype} on {tr.device}")
    rng = np.random.RandomState(21)
    # uniform images in [0, 1), as the mnist iterator scales them
    images = rng.rand(100, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=(100, 1)).astype(np.float32)
    batch = DataBatch(data=images, label=labels)
    per_step = {n: 1 for n in K2}
    counts, step_ms, peak = train_steps(torch, tr, batch, per_step)
    say(f"seq_mnist b100 bfloat16 training step: {step_ms:.3f} ms (host "
        f"clock over 10 steps, CUDA-synchronised), "
        f"{100 / step_ms * 1e3:.1f} images/s; peak memory "
        f"{peak / 2 ** 20:.1f} MiB; on {card}")
    profiled = profile_steps(torch, lambda: tr.update(batch), 5,
                             SEQ_GROUPS)
    say_profile(profiled, 5, card)
    if profiled[0]:
        say(f"K2-fwd device time per seq_mnist step: "
            f"{profiled[1]['attn_fwd kernel']:.4f} ms (the tensor-core "
            f"instance, one warpgroup and 64 query rows a block) on "
            f"{card}")
    say("== phase 8b: a float32 seq_mnist step, card vs CPU ==")
    f32_step_card_vs_cpu(torch, seq_trainer, images, labels, per_step)
    return counts, step_ms, tr


SEQ_PRED_BLOCK = """
pred = {out}
iter = mnist
    input_flat = 0
    path_img = "./data/t10k-images-idx3-ubyte.gz"
    path_label = "./data/t10k-labels-idx1-ubyte.gz"
iter = end
"""


def phase_seq_cli():
    say("== phase 8c: seq_mnist.conf through the CLI on the default device "
        "==")
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "data"))
        # noisy data (sd 60, block +60): the error is left to fall
        write_mnist(os.path.join(d, "data"), 300, 3, "train", 60.0, 60.0)
        write_mnist(os.path.join(d, "data"), 200, 4, "t10k", 60.0, 60.0)
        conf = os.path.join(d, "seq_mnist.conf")
        with open(SEQ_CONF) as f:
            text = f.read()
        # the file unmodified (its ./data/ paths resolve in `d`), with a
        # pred block appended for task = pred
        with open(conf, "w") as f:
            f.write(text + SEQ_PRED_BLOCK.format(out="pred.txt"))
        proc = run_cli([conf, "silent=0", "num_round=3", "max_round=3"],
                       cwd=d)
        errs = round_errors(proc.stderr)
        m = re.search(r"kernel launches (\{.*\})", proc.stdout)
        counts = ast.literal_eval(m.group(1)) if m else {}
        say("task=train child: " + " | ".join(
            ln for ln in proc.stderr.splitlines() if ln.startswith("[")))
        say(f"task=train child: kernel launches {counts}")
        e = [errs.get(r) for r in (1, 2, 3)]
        if None in e or not e[2] < e[0]:
            raise AssertionError(f"test-error per round {e}: should fall\n"
                                 f"{proc.stderr}")
        if any(counts.get(n, 0) <= 0 for n in K2):
            raise AssertionError(f"CLI training launched {counts}")
        proc = run_cli([conf, "continue=1", "num_round=4", "max_round=4"],
                       cwd=d)
        errs = round_errors(proc.stderr)
        if sorted(errs) != [4] or not os.path.exists(
                os.path.join(d, "models", "0004.model")):
            raise AssertionError(f"continue=1 should train round 4 only:\n"
                                 f"{proc.stdout}{proc.stderr}")
        say(f"continue=1 num_round=4: resumed, round 4 test-error "
            f"{errs[4]:g}, models/0004.model written")
        run_cli([conf, "task=pred", "model_in=models/0004.model"], cwd=d)
        with open(os.path.join(d, "pred.txt")) as f:
            preds = f.read().split()
        if len(preds) != 200:
            raise AssertionError(f"task=pred wrote {len(preds)} lines")
        say(f"task=pred: {len(preds)} lines, one per test image")
        return e


def phase_seq_serving(torch, card, tr):
    """The Server over `tr`, phase 8a's trained seq_mnist trainer (its
    fitted weights give decided argmaxes to compare)."""
    say("== phase 8d: seq_mnist.conf served (bfloat16, max_batch 100) ==")
    launches, batches, _ = serve_burst(torch, card, tr, 1, "seq_mnist")
    return launches, batches


def serve_burst(torch, card, tr, per_batch: int, label: str):
    """The Server over `tr` (a sequence-family trainer on MNIST-shaped
    rows, `per_batch` K2-fwd launches a batch): 40 requests of 1-100
    rows from 2 threads, max_batch 100; every served row against
    predict_dist. Returns (K2-fwd launches, batches, Server stats)."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.serve import Server

    srv = Server(tr, max_batch=100)
    say(f"buckets {list(srv.buckets)}; warmup {srv.warmup():.3f} s")
    rng = np.random.RandomState(13)
    sizes = [int(s) for s in rng.randint(1, 101, size=40)]
    sizes[0], sizes[1] = 100, 1
    # uniform images in [0, 1), as the mnist iterator scales them
    reqs = [rng.rand(s, 1, 28, 28).astype(np.float32) for s in sizes]
    results = [None] * len(reqs)
    errors = []

    def client(idx):
        try:
            futs = [(i, srv.submit(reqs[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(timeout=300)
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    kernels.reset_launches()
    srv.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(k, len(reqs), 2),))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    stats = srv.stop()
    launches = kernels.launches()["attn_fwd"]
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(r is None
                                                 for r in results):
        raise AssertionError("a serve request never resolved")
    if launches != per_batch * stats["batches"] or stats["batches"] == 0:
        raise AssertionError(
            f"attn_fwd launched {launches} times over {stats['batches']} "
            f"dispatched batches; {label} runs it {per_batch} times per "
            "batch")
    rows = sum(sizes)
    say(f"served {len(reqs)} requests, {rows} rows in {stats['batches']} "
        f"batches ({stats['padding_rows']} padding rows); attn_fwd "
        f"launches {launches} = {per_batch} per batch")
    say(f"{label}: latency p50 {stats['latency_p50_ms']} ms, p99 "
        f"{stats['latency_p99_ms']} ms (queue p50 {stats['queue_p50_ms']} / "
        f"p99 {stats['queue_p99_ms']} ms, device p50 "
        f"{stats['device_p50_ms']} / p99 {stats['device_p99_ms']} ms), "
        f"{rows / wall:.1f} "
        f"rows/s ({len(reqs)} requests of 1-100 rows from 2 threads, "
        f"max_batch 100, bfloat16) on {card}")
    # PR 1's bfloat16 bar (phase 4): rtol 0.1, atol 2e-4, and the argmax
    # wherever the top-2 margin is wider than the bar allows
    rtol, atol = 0.1, 2e-4
    worst = 0.0
    undecided = 0
    for data, got in zip(reqs, results):
        ref = tr.predict_dist(DataBatch(
            data=data, label=np.zeros((data.shape[0], 1), np.float32)))
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"served rows {got.shape} vs {ref.shape}")
        worst = max(worst, float(np.abs(got - ref).max()))
        if not np.allclose(got, ref, rtol=rtol, atol=atol):
            raise AssertionError(
                f"served rows differ from predict_dist: max abs "
                f"{np.abs(got - ref).max():.3e} > rtol {rtol} atol {atol}")
        top2 = np.sort(ref, axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * (atol + rtol * top2[:, 1])
        undecided += int((~decided).sum())
        if not np.array_equal(got.argmax(1)[decided],
                              ref.argmax(1)[decided]):
            raise AssertionError("served argmax differs from predict")
    say(f"served vs predict_dist: max abs {worst:.3e} (rtol {rtol}, atol "
        f"{atol}); argmax identical on {rows - undecided}/{rows} decided "
        f"rows")
    stats["rows_s"] = rows / wall
    return launches, stats["batches"], stats


# ---------------------------------------------------------------------------
# phase 9: the graph passes and int8 - K3, AlexNet served int8-quantized
# ---------------------------------------------------------------------------

INT8_PASSES = "dead_layer_elim,elim_reshape,fuse_activation,quantize_int8"

# dense int8 tensor-core rate of the H100 SXM (data sheet): what K3's
# bound is taken against
INT8_OPS_PER_S = 1.979e15

# K3's shapes, (m, k, n): AlexNet's three fullc layers at a served batch
# of 64, bench.py's int8 MLP at b16, ragged shapes, the measuring shape,
# and AlexNet b64's int8 convolutions as the im2col GEMM of one group
K3_PATH = {"fc6": (64, 9216, 4096), "fc7": (64, 4096, 4096),
           "fc8": (64, 4096, 1000)}
K3_MLP = ((16, 512, 2048), (16, 2048, 2048), (16, 2048, 10))
K3_RAGGED = tuple((m, k, n) for m in (1, 17, 100) for k in (3, 363, 1201)
                  for n in (1, 1000))
K3_MEASURE = (4096, 4096, 4096)
# name: (m, k, n, groups) - one K3 launch per group
K3_CONV = {"conv1": (193600, 363, 96, 1), "conv2": (46656, 1200, 128, 2),
           "conv3": (10816, 2304, 384, 1), "conv4": (10816, 1728, 192, 2),
           "conv5": (10816, 1728, 128, 2)}
# operands that take K3's element-load path on views one byte into their
# storage (16-byte alignment broken), with odd n, split-k and m up to an
# im2col GEMM's 193600 rows
K3_UNALIGNED = ((1, 9216, 1001), (64, 9216, 4096), (64, 4096, 1001),
                (100, 363, 97), (193600, 3, 97), (193600, 363, 96))
# K3 launches of one AlexNet batch on the int8 route: 3 fullc + 8
# convolution groups
K3_PER_ALEXNET_BATCH = 3 + sum(g for *_, g in K3_CONV.values())


def k3_bound_ms(m: int, k: int, n: int):
    """Least time for one int8 product: the larger of its bytes (x and w
    read once as int8, the int32 output written once) over the memory
    rate and its 2mnk operations over the int8 tensor-core rate."""
    bytes_ms = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m * n * k / INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def int_mm_call(torch, x, w):
    """One torch._int_mm (cuBLASLt) call computing the same product - the
    library yardstick - on operands zero-padded to its rules (more than
    16 rows, k and n multiples of 8); zeros add nothing to the sums."""
    m, k = x.shape
    n = w.shape[0]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    xp = torch.zeros((mp, kp), dtype=torch.int8, device=x.device)
    xp[:m, :k] = x
    wp = torch.zeros((np_, kp), dtype=torch.int8, device=x.device)
    wp[:n, :k] = w
    wt = wp.t()  # (k, n), column-major: w as stored
    try:
        torch._int_mm(xp, wt)
    except RuntimeError:
        wt = wt.contiguous()
    ref = torch._int_mm(xp, wt)[:m, :n]
    return (lambda: torch._int_mm(xp, wt)), ref


def phase_int8_kernel(torch, card):
    """9a: K3 against its plain version, bitwise, at every shape; times
    (CUDA events, warm and L2-cold) at the timed ones."""
    from cxxnet_tpu_torch.ops import int8 as int8_ops

    say("== phase 9a: the int8 dot K3 vs its plain version ==")
    gen = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    timed = set(K3_PATH.values()) | set(K3_MLP) | {K3_MEASURE} | {
        (m, k, n) for m, k, n, _g in K3_CONV.values()}
    shapes = (list(K3_PATH.values()) + list(K3_MLP) + list(K3_RAGGED)
              + [K3_MEASURE] + [(m, k, n) for m, k, n, _g
                                in K3_CONV.values()])
    rows = {}
    for m, k, n in shapes:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device="cuda", generator=gen)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                          device="cuda", generator=gen)
        got = int8_ops.int8_mm(x, w)
        ref = int8_ops.int8_matmul_reference(x, w)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"K3 differs from its plain version at "
                                 f"(m,k,n)=({m},{k},{n}): {bad} entries")
        if (m, k, n) not in timed:
            continue
        lib, lib_out = int_mm_call(torch, x, w)
        if not torch.equal(lib_out, ref):
            raise AssertionError(f"torch._int_mm differs at ({m},{k},{n})")
        iters = 10 if m * n * k > 1e10 else 50
        bound, by = k3_bound_ms(m, k, n)
        rows[(m, k, n)] = r = {
            "kernel": time_warm(torch, lambda: int8_ops.int8_mm(x, w),
                                iters),
            "kernel_cold": time_cold(torch, lambda: int8_ops.int8_mm(x, w),
                                     flush, 10),
            "plain": time_warm(
                torch, lambda: int8_ops.int8_matmul_reference(x, w), 5),
            "library": time_warm(torch, lib, iters),
            "bound": bound, "by": by,
            "splits": int8_ops.k3_splits(m, n, k)}
        say(f"K3 ({m},{k},{n}) splits {r['splits']}: {r['kernel']:.4f} ms "
            f"warm, {r['kernel_cold']:.4f} ms cold, "
            f"{2.0 * m * n * k / r['kernel'] / 1e9:.2f} TOP/s; plain "
            f"{r['plain']:.4f} ms; torch._int_mm {r['library']:.4f} ms; "
            f"bound {bound:.4f} ms ({by})")
    for m, k, n in K3_UNALIGNED:
        xs = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")
        ws = torch.empty(n * k + 1, dtype=torch.int8, device="cuda")
        x, w = xs[1:].view(m, k), ws[1:].view(n, k)
        x.copy_(torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              device="cuda", generator=gen))
        w.copy_(torch.randint(-127, 128, (n, k), dtype=torch.int8,
                              device="cuda", generator=gen))
        if not torch.equal(int8_ops.int8_mm(x, w),
                           int8_ops.int8_matmul_reference(x, w)):
            raise AssertionError(f"K3 differs from its plain version on "
                                 f"unaligned views at ({m},{k},{n})")
    say(f"K3 bitwise equal to its plain version at all "
        f"{len(shapes) + len(K3_UNALIGNED)} shapes ({len(K3_RAGGED)} "
        f"ragged, {len(K3_UNALIGNED)} on views 1 byte off alignment) on "
        f"{card}")
    for label, group in (
            ("fc6 + fc7 + fc8 at 64 rows",
             [(s_, 1) for s_ in K3_PATH.values()]),
            ("AlexNet b64's 8 conv GEMMs",
             [((m, k, n), g) for m, k, n, g in K3_CONV.values()])):
        tot = {key: sum(rows[sh][key] * g for sh, g in group)
               for key in ("kernel", "library", "bound")}
        say(f"K3 {label}: {tot['kernel']:.4f} ms; torch._int_mm "
            f"{tot['library']:.4f} ms ({tot['kernel'] / tot['library']:.3f}"
            f" x); bound {tot['bound']:.4f} ms on {card}")
    return rows


def served_run(torch, srv, reqs):
    """Submit `reqs` from two client threads; (results, stats, wall s)."""
    results = [None] * len(reqs)
    errors = []

    def client(idx):
        try:
            futs = [(i, srv.submit(reqs[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(timeout=300)
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    srv.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(k, len(reqs), 2),))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    stats = srv.stop()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(r is None
                                                 for r in results):
        raise AssertionError("a serve request never resolved")
    return results, stats, wall


def phase_int8_serving(torch, card, float_served):
    """9b: AlexNet.conf (bfloat16, max_batch 64) with the int8 serving
    graph passes, calibrated on the first batch, served to 30 ragged
    requests from two threads - the main path of K3."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.serve import Server

    say("== phase 9b: AlexNet.conf served int8-quantized (graph_passes = "
        f"{INT8_PASSES}) ==")
    tr = alexnet_trainer([f"graph_passes={INT8_PASSES}"])
    rng = np.random.RandomState(11)  # phase 4's requests
    sizes = [int(s) for s in rng.randint(1, 65, size=30)]
    sizes[0], sizes[1] = 64, 1
    reqs = [(rng.rand(s, 3, 227, 227) * 255.0 - 128.0).astype(np.float32)
            for s in sizes]
    t0 = time.perf_counter()
    tr.calibrate_graph_passes(DataBatch(
        data=reqs[0], label=np.zeros((64, 1), np.float32)))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    graph = tr.infer_graph(tr.net_cfg.num_nodes - 1)
    sites = [q.key for q in graph.gm.quants if q.wscale is not None]
    if tr.passes_need_calibration() or len(sites) != 8:
        raise AssertionError(f"calibration left quantized sites {sites}")
    say(f"calibrated on the first batch (64 rows) in {calib_s:.3f} s: "
        f"int8 sites {sites}")
    for line in graph.gm.log:
        say(f"  graph_passes: {line}")
    srv = Server(tr, max_batch=64)
    say(f"buckets {list(srv.buckets)}; warmup {srv.warmup():.3f} s")
    kernels.reset_launches()
    results, stats, wall = served_run(torch, srv, reqs)
    counts = kernels.launches()
    batches = stats["batches"]
    if (counts["int8_mm"] != K3_PER_ALEXNET_BATCH * batches or batches == 0
            or counts["lrn_fwd"] != 2 * batches):
        raise AssertionError(
            f"launches {counts} over {batches} batches; the int8 route "
            f"runs K3 {K3_PER_ALEXNET_BATCH} times and K1-fwd twice per "
            "batch")
    rows = sum(sizes)
    say(f"served {len(reqs)} requests, {rows} rows in {batches} batches "
        f"({stats['padding_rows']} padding rows); int8_mm launches "
        f"{counts['int8_mm']} = {K3_PER_ALEXNET_BATCH} per batch (3 fullc "
        f"+ 8 conv groups), lrn_fwd {counts['lrn_fwd']} = 2 per batch")
    say(f"int8: latency p50 {stats['latency_p50_ms']} ms, p99 "
        f"{stats['latency_p99_ms']} ms (queue p50 {stats['queue_p50_ms']} "
        f"ms, device p50 {stats['device_p50_ms']} ms), "
        f"{rows / wall:.1f} rows/s on {card}")
    f = float_served
    say(f"float (phase 4, same requests): latency p50 "
        f"{f['latency_p50_ms']} ms, p99 {f['latency_p99_ms']} ms (queue "
        f"p50 {f['queue_p50_ms']} ms, device p50 {f['device_p50_ms']} ms),"
        f" {f['rows_per_s']:.1f} rows/s")
    staged = tr.stage_infer_rows(reqs[0])
    fwd_ms = time_warm(torch, lambda: tr.infer_rows(staged), iters=10)
    say(f"full bucket of 64: int8 forward {fwd_ms:.3f} ms, float forward "
        f"{f['forward_ms']:.3f} ms (phase 4) (CUDA events)")
    say("where the int8 forward of a full bucket goes (5 forwards "
        "profiled):")
    say_profile(profile_steps(torch, lambda: tr.infer_rows(staged), 5,
                              INT8_GROUPS), 5, card)

    # served rows against predict_dist: the int8 route is row-local and
    # its products exact, so rows should agree bitwise; the gate is
    # phase 4's bfloat16 bar, and the bitwise count is reported
    rtol, atol = 0.1, 2e-4
    worst = 0.0
    exact = 0
    preds = []
    for data, got in zip(reqs, results):
        ref = tr.predict_dist(DataBatch(
            data=data, label=np.zeros((data.shape[0], 1), np.float32)))
        preds.append(ref)
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"served rows {got.shape} vs {ref.shape}")
        if not np.allclose(got, ref, rtol=rtol, atol=atol):
            raise AssertionError(
                f"int8 served rows differ from predict_dist: max abs "
                f"{np.abs(got - ref).max():.3e}")
        worst = max(worst, float(np.abs(got - ref).max()))
        exact += int(np.all(got == ref, axis=1).sum())
    say(f"int8 served vs predict_dist: {exact}/{rows} rows bitwise equal, "
        f"max abs {worst:.3e} (bar rtol {rtol}, atol {atol})")

    # the float graph's rows against the int8 graph's (reported: random
    # weights give near-uniform logits, so argmax is near a tie)
    trf = alexnet_trainer([])
    fl = np.concatenate([trf.predict_dist(DataBatch(
        data=d, label=np.zeros((d.shape[0], 1), np.float32))) for d in reqs])
    q8 = np.concatenate(preds)
    say(f"int8 graph vs float graph on {rows} rows: max abs "
        f"{np.abs(q8 - fl).max():.3e}, argmax agreement "
        f"{float((q8.argmax(1) == fl.argmax(1)).mean()):.4f} (reported, "
        "not gated: random weights)")
    del trf, srv
    torch.cuda.empty_cache()
    return tr, reqs, {"launches": counts["int8_mm"], "batches": batches,
                      "rows_per_s": rows / wall, "stats": stats,
                      "forward_ms": fwd_ms}


def site_taps(torch, graph, staged):
    """{quant site key: (layer, params, input activation)} of one
    forward of the transformed graph."""
    from cxxnet_tpu_torch.nnet.network import param_key
    gm = graph.gm
    by_live = {live: new for new, live in gm.param_map().items()}
    idx = {param_key(gm.cfg, i): i for i, li in enumerate(gm.cfg.layers)
           if not li.is_shared}
    want = {q.key: idx[by_live[q.key]] for q in gm.quants
            if q.wscale is not None}
    taps = {i: None for i in want.values()}
    params = graph.params()
    with torch.inference_mode():
        graph.net(params, staged, taps=taps)
    return {k: (graph.net.layer_objs[i], params[by_live[k]], taps[i])
            for k, i in want.items()}


def site_acc(torch, layer, p, x, plain):
    """A quant site's int32 accumulator from its input activation: K3's
    route, or the plain version with `plain`."""
    from cxxnet_tpu_torch.ops import int8 as int8_ops
    xq = int8_ops.quantize_act(x, p["ascale"])
    if p["wmat_q"].dim() == 4:
        q = layer.param
        conv = (int8_ops.int8_conv2d_reference if plain
                else int8_ops.int8_conv2d)
        return xq, conv(xq, p["wmat_q"], q.stride, q.pad_y, q.pad_x,
                        q.num_group)
    mm = (int8_ops.int8_matmul_reference if plain
          else int8_ops.int8_matmul)
    xq = xq.reshape(xq.shape[0], -1)
    return xq, mm(xq, p["wmat_q"])


def phase_int8_sites(torch, card, tr, reqs):
    """9c: each quantized site's int32 accumulator, card route against
    the plain version on the same int8 operands; then a float32-compute
    int8 forward (TF32 off, b8) on the card against the CPU."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch

    say("== phase 9c: per-site int32 accumulators; float32 int8 forward, "
        "card vs CPU ==")
    graph = tr.infer_graph(tr.net_cfg.num_nodes - 1)
    taps = site_taps(torch, graph, tr.stage_infer_rows(reqs[0]))
    for key, (layer, p, x) in taps.items():
        _xq, card_acc = site_acc(torch, layer, p, x, plain=False)
        _xq, plain_acc = site_acc(torch, layer, p, x, plain=True)
        torch.cuda.synchronize()
        if not torch.equal(card_acc, plain_acc):
            raise AssertionError(f"{key}: K3-route accumulator differs "
                                 "from the plain version's")
        say(f"  {key}: int32 accumulator {tuple(card_acc.shape)} bitwise "
            f"equal (|acc| max {int(card_acc.abs().max())})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    over = [f"graph_passes={INT8_PASSES}", "dtype=float32", "batch_size=8"]
    gpu = alexnet_trainer(over)
    cpu = alexnet_trainer(over + ["dev=cpu"])
    batch = DataBatch(data=reqs[0][:8], label=np.zeros((8, 1), np.float32))
    cpu.calibrate_graph_passes(batch)
    gpu.set_calibration(*cpu.calibration())  # one set of scales
    g_rows, c_rows = gpu.predict_dist(batch), cpu.predict_dist(batch)
    node = gpu.net_cfg.num_nodes - 1
    gt = site_taps(torch, gpu.infer_graph(node),
                   gpu.stage_infer_rows(batch.data))
    ct = site_taps(torch, cpu.infer_graph(node),
                   cpu.stage_infer_rows(batch.data))
    differ = total = 0
    for key in gt:
        gq, _ = site_acc(torch, *gt[key], plain=True)
        cq, _ = site_acc(torch, *ct[key], plain=True)
        differ += int((gq.cpu() != cq).sum())
        total += cq.numel()
    # the float32 layers between the int8 products (dequantize, relu,
    # pooling, LRN, softmax) differ by ulps between card and CPU, and an
    # ulp can move an activation across an int8 rounding boundary: one
    # quantum at one input of the next product. rtol 1e-2 bounds that
    rtol, atol = 1e-2, 1e-6
    diff = float(np.abs(g_rows - c_rows).max())
    if not (np.allclose(g_rows, c_rows, rtol=rtol, atol=atol)
            and np.array_equal(g_rows.argmax(1), c_rows.argmax(1))):
        raise AssertionError(f"float32 int8 forward, card vs CPU: max abs "
                             f"{diff:.3e} > rtol {rtol} atol {atol}, or "
                             "argmax differs")
    say(f"float32 int8 forward (TF32 off, b8) card vs CPU, one set of "
        f"scales: max abs {diff:.3e} (rtol {rtol}, atol {atol}), argmax "
        f"equal; {differ}/{total} int8 activations differ")
    del gpu, cpu


# bench.py's _INT8_MLP_CONF (bench.py:1284-1305), unmodified; the
# trainer is put on the card by its constructor's device
INT8_MLP_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 2048
  init_sigma = 0.05
layer[+1:bn1] = batch_norm:bn1
layer[+1:r1] = relu
layer[+1:fc2] = fullc:fc2
  nhidden = 2048
  init_sigma = 0.05
layer[+1:bn2] = batch_norm:bn2
layer[+1:r2] = relu
layer[+1:fc3] = fullc:fc3
  nhidden = 10
  init_sigma = 0.05
layer[+0] = softmax
netconfig=end
input_shape = 1,1,512
dev = cpu
eta = 0.1
silent = 1
seed = 19
"""


def phase_int8_mlp(torch, card):
    """9d: the JAX package's int8 pair (bench.py _bench_int8) on the
    card: the same predict_dist loop over the same rows, folded float
    against folded + int8; argmax agreement on 256 held-out rows."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    say("== phase 9d: bench.py's int8 MLP pair (b16) on the card ==")
    batch = 16

    def build(extra=""):
        tr = NetTrainer(cfg=INT8_MLP_CONF + f"batch_size = {batch}\n"
                        "graph_passes = dead_layer_elim,fold_conv_bn,"
                        "fuse_activation" + extra + "\n", device="cuda:0")
        tr.init_model()
        return tr

    rng = np.random.RandomState(41)
    db = DataBatch(data=rng.rand(batch, 1, 1, 512).astype(np.float32),
                   label=rng.randint(0, 10, (batch, 1)).astype(np.float32))

    def ips_of(tr, budget_s=1.5):
        tr.predict_dist(db)  # calibration
        t0 = time.perf_counter()
        tr.predict_dist(db)
        per = max(time.perf_counter() - t0, 1e-6)
        n = max(3, min(256, int(budget_s / per)))
        t0 = time.perf_counter()
        for _ in range(n):
            tr.predict_dist(db)
        return n * batch / (time.perf_counter() - t0)

    fold_tr, int8_tr = build(), build(",quantize_int8")
    folded = ips_of(fold_tr)
    kernels.reset_launches()
    int8 = ips_of(int8_tr)
    if kernels.launches()["int8_mm"] == 0:
        raise AssertionError("the int8 MLP launched no K3")
    agree = total = 0
    for i in range(256 // batch):
        r = np.random.RandomState(900 + i)
        eb = DataBatch(data=r.rand(batch, 1, 1, 512).astype(np.float32),
                       label=r.randint(0, 10, (batch, 1)).astype(np.float32))
        pf = fold_tr.predict_dist(eb)
        pq = int8_tr.predict_dist(eb)
        if not (np.all(np.isfinite(pq)) and pq.shape == (batch, 10)):
            raise AssertionError("int8 MLP rows not finite")
        agree += int((pf.argmax(1) == pq.argmax(1)).sum())
        total += batch
    say(f"int8 MLP b16 (predict_dist loop, host clock): int8 {int8:.1f} "
        f"rows/s, folded float {folded:.1f} rows/s, int8_over_fold "
        f"{int8 / folded:.4f}; argmax agreement {agree / total:.4f} on "
        f"{total} held-out rows, on {card}")
    return {"int8_over_fold": int8 / folded, "argmax_agree": agree / total}


def phase_int8_cli():
    """9e: the CLI's task = pred and task = serve with the int8 passes
    (a conv + lrn + fullc net, MNIST-format data): identical outputs,
    the calibration lines printed, K3 launched; pass_calibration_batches
    = 2 and pass_calibration_iter each run once."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    say("== phase 9e: CLI task=pred / task=serve with quantize_int8 ==")
    with tempfile.TemporaryDirectory() as d:
        write_mnist(d, 500, 4)
        conf = os.path.join(d, "net.conf")
        with open(conf, "w") as f:
            f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d))
        tr = NetTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d))
        tr.init_model()
        model = os.path.join(d, "0001.model")
        with open(model, "wb") as fo:
            tr.save_model(fo)
        common = [conf, f"model_in={model}", f"graph_passes={INT8_PASSES}"]
        outs = {}
        # the three children are independent: side by side
        runs = (("pred", ["pass_calibration_batches=2"],
                 "graph_passes: calibrated on 2 batch(es) from the pred "
                 "iterator"),
                ("serve", ["pass_calibration_batches=2", "serve_rows=0"],
                 "graph_passes: calibrated on 2 batch(es) from the pred "
                 "iterator"),
                ("pred1", ["pass_calibration_iter=pred"],
                 "graph_passes: calibrated on 1 batch(es) from the pred "
                 "iterator"))
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(runs)) as pool:
            procs = {name: pool.submit(run_cli, common + [
                f"task={'serve' if name == 'serve' else 'pred'}",
                f"pred={os.path.join(d, name + '.txt')}"] + extra)
                for name, extra, _ in runs}
            procs = {name: f.result() for name, f in procs.items()}
        for name, extra, line in runs:
            out = os.path.join(d, f"{name}.txt")
            proc = procs[name]
            if line not in proc.stdout:
                raise AssertionError(f"{name}: no `{line}` line:\n"
                                     f"{proc.stdout}")
            with open(out) as f:
                outs[name] = f.read()
            if name == "serve":
                m = re.search(r"kernel launches (\{.*\})", proc.stdout)
                if not m or ast.literal_eval(m.group(1))["int8_mm"] == 0:
                    raise AssertionError(f"task=serve launched no K3:\n"
                                         f"{proc.stdout}")
                say("task=serve child (beside the two pred children): "
                    + next(ln for ln in proc.stdout.splitlines()
                           if "kernel launches" in ln))
        n_lines = outs["pred"].count("\n")
        if outs["pred"] != outs["serve"] or n_lines != 500 or \
                outs["pred1"].count("\n") != 500:
            raise AssertionError("int8 task=serve output differs from "
                                 f"task=pred ({n_lines} pred lines)")
        say(f"int8 task=pred and task=serve outputs identical ({n_lines} "
            f"lines); pass_calibration_batches=2 and "
            f"pass_calibration_iter=pred each calibrated once")


def int8_entry(k3_rows, served, max_err: int):
    """K3's entry of the kernels line: the unit is the three fullc
    launches of one served AlexNet batch of 64 (fc6, fc7, fc8), L2 warm,
    summed; the other shapes ride along under their own keys."""
    path = [k3_rows[s] for s in K3_PATH.values()]

    def total(key, rows=path):
        return round(sum(r[key] for r in rows), 6)

    conv = [k3_rows[(m, k, n)] for m, k, n, _g in K3_CONV.values()]
    groups = [g for *_, g in K3_CONV.values()]

    def conv_total(key):
        return round(sum(r[key] * g for r, g in zip(conv, groups)), 6)

    meas = k3_rows[K3_MEASURE]
    mlp = [k3_rows[s] for s in K3_MLP]
    return {
        "name": "int8_mm",
        "route": "cuda",
        "source": "cxxnet_tpu_torch/csrc/int8_mm.cu",
        "replaces": "cxxnet_tpu/ops/int8.py:109",
        "replaces_fn": "_mm_kernel",
        "unit": "the three fullc launches of one AlexNet batch of 64: fc6 "
                "(64,9216)x(4096,9216)^T, fc7 (64,4096)x(4096,4096)^T, fc8 "
                "(64,4096)x(1000,4096)^T, L2 warm",
        "launches": served["launches"],
        "launches_unit": f"AlexNet.conf served int8 (phase 9b), "
                         f"{served['batches']} batches, "
                         f"{K3_PER_ALEXNET_BATCH} per batch",
        "max_abs_err": max_err,
        "ms": total("kernel"),
        "kernel_cold_ms": total("kernel_cold"),
        "plain_ms": total("plain"),
        "bound_ms": total("bound"),
        "bound_by": path[0]["by"],
        "library_ms": total("library"),
        "library_unit": "torch._int_mm (cuBLASLt), operands padded to its "
                        "alignment",
        "conv_ms": conv_total("kernel"),
        "conv_plain_ms": conv_total("plain"),
        "conv_bound_ms": conv_total("bound"),
        "conv_library_ms": conv_total("library"),
        "conv_unit": "the 8 im2col GEMMs of AlexNet b64's int8 "
                     "convolutions, L2 warm",
        "mlp_ms": total("kernel", mlp),
        "mlp_plain_ms": total("plain", mlp),
        "mlp_bound_ms": total("bound", mlp),
        "mlp_library_ms": total("library", mlp),
        "measure_ms": round(meas["kernel"], 6),
        "measure_cold_ms": round(meas["kernel_cold"], 6),
        "measure_plain_ms": round(meas["plain"], 6),
        "measure_bound_ms": round(meas["bound"], 6),
        "measure_library_ms": round(meas["library"], 6),
        "measure_unit": "one launch at (m,k,n) = (4096,4096,4096)",
    }


ATTN_SOURCES = {"attn_fwd": ("attn_fwd.cu", 90, "_fwd_kernel"),
                "attn_dq": ("attn_dq.cu", 172, "_dq_kernel"),
                "attn_dkv": ("attn_dkv.cu", 211, "_dkv_kernel")}


def attn_entry(name: str, rows, max_err: float, launches: int):
    """One K2 kernel's entry of the kernels line: the unit is one launch
    at the measuring shape (4,8,4096,128), bfloat16, non-causal, L2
    warm; `causal_ms` the same causal; `path_ms` one launch at
    seq_mnist's shape (100,4,28,7), where launch latency, not the bound,
    sets the time (warm: back-to-back calls, so the host's enqueue rate;
    `path_cold_ms`: one synchronised call)."""
    src, line, fn = ATTN_SOURCES[name]
    m = rows[(name, MEASURE_ATTN_SHAPE, False)]
    c = rows[(name, MEASURE_ATTN_SHAPE, True)]
    p = rows[(name, SEQ_ATTN_SHAPE, False)]
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"cxxnet_tpu_torch/csrc/{src}",
        "replaces": f"cxxnet_tpu/ops/pallas_attention.py:{line}",
        "replaces_fn": fn,
        "unit": "one launch at (4,8,4096,128) bfloat16, non-causal, L2 "
                "warm",
        "launches": launches,
        "launches_unit": "seq_mnist.conf training, 12 steps (phase 8a)",
        "max_abs_err": max_err,
        "ms": round(m["kernel"], 6),
        "kernel_cold_ms": round(m["kernel_cold"], 6),
        "tflops": round(m["flops"] / m["kernel"] / 1e9, 3),
        "plain_ms": round(m["plain"], 6),
        "bound_ms": round(m["bound"], 6),
        "bound_by": m["by"],
        "library_ms": round(m["library"], 6),
        "library_unit": ("scaled_dot_product_attention" if name == "attn_fwd"
                         else "backward of scaled_dot_product_attention "
                              "(dq, dk, dv in one call)"),
        "causal_ms": round(c["kernel"], 6),
        "causal_plain_ms": round(c["plain"], 6),
        "causal_bound_ms": round(c["bound"], 6),
        "causal_library_ms": round(c["library"], 6),
        "path_unit": "one launch at (100,4,28,7) bfloat16, non-causal: "
                     "seq_mnist.conf's core and each of stack_moe.conf's "
                     "4 blocks",
        "path_ms": round(p["kernel"], 6),
        "path_cold_ms": round(p["kernel_cold"], 6),
        "path_plain_ms": round(p["plain"], 6),
        "path_bound_ms": round(p["bound"], 6),
        "path_library_ms": round(p["library"], 6),
    }
    if name != "attn_fwd":
        # the backward pair against the library's one backward call, and
        # forward + backward through autograd (phase 3c)
        pair = (rows[("attn_dq", MEASURE_ATTN_SHAPE, False)]["kernel"]
                + rows[("attn_dkv", MEASURE_ATTN_SHAPE, False)]["kernel"])
        fb = rows[("attn_dkv", MEASURE_ATTN_SHAPE, False)]["fwd_bwd"]
        entry.update({
            "pair_ms": round(pair, 6),
            "pair_over_library": round(pair / m["library"], 4),
            "fwd_bwd_ms": round(fb["port"], 6),
            "library_fwd_bwd_ms": round(fb["library"], 6),
        })
    return entry


# ---------------------------------------------------------------------------
# phase 10: the image pipeline on the card (imgbin through the CLI)
# ---------------------------------------------------------------------------

IMAGENET_CONFS = os.path.join(REPO, "examples", "ImageNet")
BOWL_CONFS = os.path.join(REPO, "examples", "kaggle_bowl")
# AlexNet.conf's test block again, as a pred block (phase 7 appends one
# to its conf the same way)
ALEXNET_PRED_BLOCK = """
pred = pred.txt
iter = imgbin
  image_list = "./data/test.lst"
  image_bin = "./data/test.bin"
  image_root = "./data/resize256/"
  image_mean = "models/image_net_mean.bin"
iter = end
"""


def image_format_used():
    """JPEG (quality 90, written with PIL) where PIL imports, else binary
    P6 written with numpy; with PIL's version or None."""
    try:
        import PIL
        from PIL import Image  # noqa: F401
        return "JPEG", PIL.__version__
    except ImportError:
        return "PPM", None


def write_image_set(d: str, sub: str, lst: str, n: int, size: int,
                    classes: int, seed: int, fmt: str,
                    kind: str = "") -> None:
    """n size x size RGB images under d/sub/ with a class signal (a
    bright square whose place and channel follow the label, over
    noise), their .lst at d/lst.lst, packed into d/lst.bin by the port's
    im2bin. A JPEG is PIL's default (4:2:0), or of `kind` (io/native.py's
    JPEG_KINDS, by its encode_jpeg)."""
    import io
    import numpy as np
    from cxxnet_tpu_torch.tools.im2bin import im2bin
    rng = np.random.RandomState(seed)
    root = os.path.join(d, sub)
    os.makedirs(root, exist_ok=True)
    side = max(4, size // 6)
    lines = []
    for i in range(n):
        cls = i % classes
        img = rng.randint(0, 150, (size, size, 3)).astype(np.uint8)
        r, c = divmod(cls % 16, 4)
        y0, x0 = r * size // 4, c * size // 4
        img[y0:y0 + side, x0:x0 + side, cls % 3] = 250
        name = f"{i:05d}." + ("jpg" if fmt == "JPEG" else "ppm")
        if fmt == "JPEG" and kind:
            from cxxnet_tpu_torch.io.native import encode_jpeg
            blob = encode_jpeg(img, kind)
        elif fmt == "JPEG":
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            blob = buf.getvalue()
        else:
            blob = (f"P6\n{size} {size}\n255\n".encode()
                    + img.tobytes())
        with open(os.path.join(root, name), "wb") as f:
            f.write(blob)
        lines.append(f"{i}\t{cls}\t{name}")
    os.makedirs(os.path.dirname(os.path.join(d, lst)) or d, exist_ok=True)
    with open(os.path.join(d, lst + ".lst"), "w") as f:
        f.write("\n".join(lines) + "\n")
    devnull = open(os.devnull, "w")
    keep, sys.stdout = sys.stdout, devnull
    try:
        im2bin(os.path.join(d, lst + ".lst"), root + "/",
               os.path.join(d, lst + ".bin"))
    finally:
        sys.stdout = keep
        devnull.close()


def round_metrics(stderr: str):
    """{round: {metric: value}} from the per-round `[N]\t...` lines."""
    out = {}
    for ln in stderr.splitlines():
        m = re.match(r"\[(\d+)\]((\t[\w@-]+:[0-9.e+-]+|\t[\w@-]+:nan)*)$",
                     ln.strip("\n"))
        if m:
            out[int(m.group(1))] = {
                k: float(v) for k, v in
                (t.rsplit(":", 1) for t in m.group(2).split("\t") if t)}
    return out


def cli_launches(stdout: str):
    """The CLI's `kernel launches {...}` line, with its `decoder raw
    hand-backs N` line as the key "raw_handbacks" where it printed one."""
    m = re.search(r"kernel launches (\{.*\})", stdout)
    counts = ast.literal_eval(m.group(1)) if m else {}
    m = re.search(r"decoder raw hand-backs (\d+)", stdout)
    if m:
        counts["raw_handbacks"] = int(m.group(1))
    return counts


def cli_train_checked(conf, cwd, rounds, label, extra=()):
    """`task = train` from scratch for `rounds` rounds in `cwd`: every
    round's line, finite values, models/000<rounds>.model written.
    Returns (metrics per round, kernel launches, seconds)."""
    import numpy as np
    t0 = time.perf_counter()
    proc = run_cli([conf, f"num_round={rounds}", f"max_round={rounds}",
                    "silent=0"] + list(extra), cwd=cwd)
    secs = time.perf_counter() - t0
    mets = round_metrics(proc.stderr)
    counts = cli_launches(proc.stdout)
    say(f"{label}: " + " | ".join(
        ln for ln in proc.stderr.splitlines() if ln.startswith("[")))
    if sorted(mets) != list(range(1, rounds + 1)):
        raise AssertionError(f"{label}: rounds {sorted(mets)}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    vals = [v for r in mets.values() for v in r.values()]
    if not vals or not all(np.isfinite(vals)):
        raise AssertionError(f"{label}: non-finite metrics {mets}")
    model = os.path.join(cwd, "models", f"{rounds:04d}.model")
    if not os.path.exists(model):
        raise AssertionError(f"{label}: {model} was not written")
    say(f"{label}: {rounds} rounds in {secs:.1f} s (the whole process; "
        f"an image conf's first run creates the mean image); kernel "
        f"launches {counts}")
    return mets, counts, secs


def stage_equal(torch, got, want) -> bool:
    return (got.data.dtype == want.data.dtype
            and torch.equal(got.data, want.data)
            and torch.equal(got.mask, want.mask)
            and all(torch.equal(got.labels[k], want.labels[k])
                    for k in want.labels))


class ListIter:
    """A DataIter over a list (of DataBatch or DataInst)."""

    def __init__(self, items):
        self.items = items

    def set_param(self, name, val):
        pass

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < len(self.items)

    def value(self):
        return self.items[self.i]


def alexnet_train_block():
    """(global pairs, train block) of AlexNet.conf, split as the CLI
    splits it (the block keeps its `iter = end`)."""
    from cxxnet_tpu_torch.main import LearnTask
    task = LearnTask()
    task.load_conf(os.path.join(IMAGENET_CONFS, "AlexNet.conf"))
    defcfg, train, _evals, _pred = task._split_blocks()
    return defcfg, train + [("iter", "end")]


def make_iter(conf, cwd, extra=(), device=None):
    """The iterator the CLI builds from a (global pairs, block) conf run
    in `cwd`: the block's chain, the global pairs set on it (batch_size,
    input_shape, ...), relative file paths resolved from `cwd`; `device`
    as create_iterator takes it (it routes use_native)."""
    from cxxnet_tpu_torch.io import create_iterator
    defcfg, block = conf
    paths = ("image_list", "image_bin", "image_root", "image_mean")

    def fix(pairs):
        return [(k, os.path.join(cwd, v) if k in paths else v)
                for k, v in pairs]
    it = create_iterator(fix(block[:-1]) + list(extra) + block[-1:],
                         device=device)
    for k, v in fix(defcfg) + [("silent", "1")]:
        it.set_param(k, v)
    it.init()
    return it


def pull(it, n):
    """n batches of an iterator (rewinding at the end of a pass), their
    arrays copied."""
    from cxxnet_tpu_torch.io.data import DataBatch
    out = []
    it.before_first()
    while len(out) < n:
        if not it.next():
            it.before_first()
            continue
        b = it.value()
        out.append(DataBatch(data=b.data.copy(), label=b.label.copy(),
                             num_batch_padd=b.num_batch_padd))
    return out


def replay_host_draws(torch, seed, n, yy_max, xx_max, rand_crop,
                      rand_mirror):
    """The host AugmentIterator's draws for its first n instances,
    replayed from its RandomState(0 + seed_data) in its order."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx, con, ill, mir = [], [], [], [], []
    for _ in range(n):
        a = b = 0
        if rand_crop and (yy_max or xx_max):
            a, b = rng.randint(0, yy_max + 1), rng.randint(0, xx_max + 1)
        yy.append(a)
        xx.append(b)
        con.append(rng.uniform())
        ill.append(rng.uniform())
        mir.append(bool(rand_mirror and rng.uniform() < 0.5))
    return {"yy": torch.tensor(yy), "xx": torch.tensor(xx),
            "mirror": torch.tensor(mir),
            "contrast": torch.tensor(con, dtype=torch.float64),
            "illumination": torch.tensor(ill, dtype=torch.float64)}


def phase_alexnet_cli(d: str):
    """(c): AlexNet.conf through the CLI on its own imgbin data, in a
    directory of its own whose ./data/ links to the shared set (the
    conf's relative paths resolve unedited): 2 rounds, continue = 1,
    task = pred. Returns its kernel launches."""
    say("== phase 10c: examples/ImageNet/AlexNet.conf through the CLI on "
        "imgbin data (b256, bfloat16, full width) ==")
    alex = os.path.join(d, "alexnet")
    os.makedirs(alex)
    os.symlink(os.path.join(d, "shared", "data"), os.path.join(alex, "data"))
    conf = os.path.join(IMAGENET_CONFS, "AlexNet.conf")
    mets, counts, _ = cli_train_checked(conf, alex, 2, "AlexNet.conf",
                                        ["metric=logloss"])
    for r, m in mets.items():
        for k in ("test-error", "test-rec@1", "test-rec@5",
                  "train-logloss", "test-logloss"):
            if k not in m:
                raise AssertionError(f"round {r} lacks {k}: {m}")
    if counts.get("lrn_fwd", 0) <= 0 or counts.get("lrn_bwd", 0) <= 0:
        raise AssertionError(f"AlexNet.conf CLI training launched {counts}")
    if not os.path.exists(os.path.join(alex, "models",
                                       "image_net_mean.bin")):
        raise AssertionError("the first run did not create the mean image")
    proc = run_cli([conf, "continue=1", "num_round=3", "max_round=3"],
                   cwd=alex)
    got = round_metrics(proc.stderr)
    if sorted(got) != [3] or not os.path.exists(
            os.path.join(alex, "models", "0003.model")):
        raise AssertionError(f"continue=1 should train round 3 only:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    if "image_net_mean" in proc.stdout and "cannot find" in proc.stdout:
        raise AssertionError("continue=1 recreated the mean image")
    say(f"continue=1 num_round=3: resumed past models/image_net_mean.bin, "
        f"round 3 {got[3]}")
    pconf = os.path.join(alex, "alexnet_pred.conf")
    with open(conf) as f, open(pconf, "w") as g:
        g.write(f.read() + ALEXNET_PRED_BLOCK)
    proc = run_cli([pconf, "task=pred", "model_in=models/0003.model"],
                   cwd=alex)
    with open(os.path.join(alex, "pred.txt")) as f:
        preds = f.read().split()
    if len(preds) != 256:
        raise AssertionError(f"task=pred wrote {len(preds)} lines")
    say(f"task=pred: {len(preds)} lines, {len(set(preds))} distinct "
        "classes")
    return counts


def phase_image_confs_cli(d: str, fmt: str) -> None:
    """(d): ResNet18.conf and bowl.conf + pred.conf through the CLI, as
    (c) does AlexNet.conf."""
    import numpy as np
    say("== phase 10d: ResNet18.conf and kaggle_bowl/bowl.conf + pred.conf "
        "through the CLI, the two side by side ==")
    res = os.path.join(d, "resnet18")
    os.makedirs(res)
    os.symlink(os.path.join(d, "shared", "data"), os.path.join(res, "data"))
    bowl = os.path.join(d, "bowl")

    def bowl_train():
        write_image_set(bowl, "img_tr", "tr", 256, 64, 12, 31, fmt)
        write_image_set(bowl, "img_va", "va", 128, 64, 12, 32, fmt)
        write_image_set(bowl, "img_te", "te", 128, 64, 12, 33, fmt)
        cli_train_checked(os.path.join(BOWL_CONFS, "bowl.conf"), bowl, 2,
                          "bowl.conf")

    side_by_side(lambda: cli_train_checked(
        os.path.join(IMAGENET_CONFS, "ResNet18.conf"), res, 2,
        "ResNet18.conf"), bowl_train)
    run_cli([os.path.join(BOWL_CONFS, "pred.conf"),
             "model_in=models/0002.model"], cwd=bowl)
    with open(os.path.join(bowl, "test.txt")) as f:
        rows = [ln.split() for ln in f.read().splitlines()]
    vals = np.asarray(rows, dtype=np.float64)
    if vals.shape != (128, 121) or not np.allclose(vals.sum(1), 1.0,
                                                    atol=1e-3):
        raise AssertionError(f"pred.conf (pred_raw) wrote {vals.shape}, "
                             f"row sums {vals.sum(1)[:4]}")
    say(f"pred.conf (task = pred_raw): {vals.shape[0]} rows of "
        f"{vals.shape[1]} probabilities, each summing to 1")


def phase_staged_vs_streamed(torch, d: str):
    """(e): two AlexNet batches of AlexNet.conf's train block; the
    prefetcher's tensors (pinned ring, side stream) against stage_batch's
    streamed ones, bitwise, under stage_dtype bfloat16 (the default) and
    float32 and under device_augment = 1 (raw uint8)."""
    say("== phase 10e: StagedPrefetcher (pinned ring, side stream) vs "
        "streamed staging, two AlexNet batches ==")
    alex = os.path.join(d, "alexnet")
    block = alexnet_train_block()
    host = pull(make_iter(block, alex), 2)
    raw = pull(make_iter(block, alex, [("device_augment", "1")]), 2)
    tr = alexnet_trainer([])
    for label, sd, daug, batches in (("stage_dtype bfloat16", "", 0, host),
                                     ("stage_dtype float32", "float32", 0,
                                      host),
                                     ("device_augment = 1", "", 1, raw)):
        tr.stage_dtype, tr.device_augment = sd, daug
        pf = tr.prefetch(ListIter(batches), 1)
        pf.before_first()
        n = 0
        while pf.next():
            got = pf.value()
            tr._await(got)
            if got.ready is None or not stage_equal(
                    torch, got, tr.stage_batch(batches[n])):
                raise AssertionError(f"{label}: staged batch {n} differs "
                                     "from the streamed one")
            n += 1
        pf.close()
        if n != 2:
            raise AssertionError(f"{label}: {n} staged batches")
        say(f"{label}: 2 staged batches ({got.data.dtype}, "
            f"{tuple(got.data.shape)}) bitwise equal to the streamed ones")
    tr.stage_dtype, tr.device_augment = "", 0
    del tr
    torch.cuda.empty_cache()


def phase_device_augment_vs_host(torch, d: str):
    """(f): ops/augment.py on the card, given the host AugmentIterator's
    draws replayed from its RandomState, against the host pipeline's
    float32 instances: AlexNet.conf's train spec (rand_crop, rand_mirror,
    the crop-sized mean image of 10c) and a spec with every jitter key
    (mean_value, contrast, illumination, divideby). Bar: bitwise (the
    same float32 operations in the same order)."""
    import numpy as np
    from cxxnet_tpu_torch.io.augment import AugmentIterator, load_mean_image
    from cxxnet_tpu_torch.io.data import DataInst
    from cxxnet_tpu_torch.ops.augment import make_device_augment
    say("== phase 10f: device augment on the card vs the host pipeline ==")
    alex = os.path.join(d, "alexnet")
    block = alexnet_train_block()
    raw = pull(make_iter(block, alex, [("device_augment", "1")]), 1)[0]
    n = 32
    mean = load_mean_image(os.path.join(alex, "models", "image_net_mean.bin"))
    specs = {
        "AlexNet.conf train block": (
            dict(rand_crop=1, rand_mirror=1), mean, None),
        "mean_value + contrast + illumination + divideby": (
            dict(rand_crop=1, rand_mirror=1, max_random_contrast=0.3,
                 max_random_illumination=20.0, scale=1 / 256), None,
            (104.0, 117.0, 123.0)),
    }

    class Base:
        def __init__(self):
            self.i = -1

        def set_param(self, k, v):
            pass

        def before_first(self):
            self.i = -1

        def next(self):
            self.i += 1
            return self.i < n

        def value(self):
            return DataInst(index=self.i, data=raw.data[self.i],
                            label=raw.label[self.i])

    for label, (kw, meanimg, mv) in specs.items():
        host = AugmentIterator(Base())
        host.set_param("input_shape", "3,227,227")
        host.set_param("seed_data", "5")
        for k, v in kw.items():
            host.set_param(k, repr(float(v)) if k == "scale" else str(v))
        if mv is not None:
            host.set_param("mean_value", ",".join(str(t) for t in mv))
        host.meanimg = meanimg
        host.before_first()
        want = []
        while host.next():
            want.append(host.value().data)
        want = np.stack(want)
        fn = make_device_augment(
            (3, 227, 227), mean_loader=(lambda m=meanimg: m)
            if meanimg is not None else None, mean_values=mv, **kw)
        draws = replay_host_draws(torch, 5, n, 256 - 227, 256 - 227,
                                  kw.get("rand_crop", 0),
                                  kw.get("rand_mirror", 0))
        got = fn(torch.from_numpy(raw.data[:n]).cuda(), True,
                 draws={k: v.cuda() for k, v in draws.items()})
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        if got.shape != want.shape:
            raise AssertionError(f"{label}: card {got.shape}, host "
                                 f"{want.shape}")
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: card vs host max abs diff "
                                 f"{np.abs(got - want).max()}")
        say(f"{label}: {n} instances, card == host pipeline bitwise "
            f"(float32, {tuple(got.shape)})")


def timed_setting(torch, tr, itr, prefetch):
    """2 warm-up and 6 timed steps of tr.update over itr's batches (the
    12 batches of one pass), then 3 profiled ones: step ms and images/s
    by the host clock (CUDA-synchronised), the device's idle share."""
    it = tr.prefetch(itr, 1) if prefetch else itr
    it.before_first()

    def step():
        if not it.next():
            it.before_first()
            if not it.next():
                raise AssertionError("empty iterator")
        tr.update(it.value())

    try:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 6
        profiled = profile_steps(torch, step, 3, strict=True)
    finally:
        if prefetch:
            it.close()
    rows, groups, busy_ms, window_ms = profiled
    idle = (1 - busy_ms / window_ms) if window_ms else float("nan")
    return step_ms, idle


def iterator_rate(itr, batches: int = 4) -> float:
    """Images/s of the iterator alone (decode, augment, batch; no
    trainer) over its first `batches` batches of a pass."""
    itr.before_first()
    n, k, t0 = 0, 0, time.perf_counter()
    while k < batches and itr.next():
        n += itr.value().data.shape[0] - itr.value().num_batch_padd
        k += 1
    return n / (time.perf_counter() - t0)


def stop_iter(it) -> None:
    """Stop a threadbuffer chain's producer thread (it would otherwise
    go on decoding the next batches while something else is timed)."""
    shutdown = getattr(it, "_shutdown", None)
    if shutdown is not None:
        shutdown()


def say_setting(results, label, step_ms, idle, device_ms, card,
                rate=None, stage=None, staged_as="bfloat16"):
    """One setting's line: step, images/s, idle share, what sets the
    pace; and its entry in `results`."""
    ips = 256 / step_ms * 1e3
    if ips >= 0.85 * (256 / device_ms * 1e3):
        pace = "the step itself (its device work and host dispatch)"
    elif rate is not None and rate < 1.15 * ips:
        pace = "the iterator (decode, augment, batch on the host)"
    else:
        pace = "staging and the step's host work"
    results[label] = dict(step_ms=step_ms, images_s=ips, idle=idle)
    extra = ""
    if rate is not None:
        results[label].update(iterator_images_s=rate,
                              staging_ms=stage["bfloat16"],
                              staging_f32_ms=stage["float32"])
        extra = (f"; staging {stage['bfloat16']:.3f} ms ({staged_as} "
                 f"across) or {stage['float32']:.3f} ms (stage_dtype = "
                 f"float32); iterator alone {rate:.1f} images/s")
    idle_txt = "not measured" if idle != idle else f"{idle:.4f}"
    say(f"[{label}] step {step_ms:.3f} ms, {ips:.1f} images/s (host "
        f"clock over 6 steps, CUDA-synchronised); device idle share "
        f"{idle_txt} (torch.profiler, 3 steps){extra}; the pace is set by "
        f"{pace}; on {card}")


def host_stage_rates(tdir: str, card: str):
    """Images/s of each host stage of the iterator alone, over the first
    512 images of the timing set: decode on one thread and on the
    iterator's pool of 4, the host augmenter with AlexNet.conf's train
    spec (crop, mirror, the mean image; one thread, as in the chain),
    and the batch adapter's collation of 256 augmented instances."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from cxxnet_tpu_torch.io.augment import AugmentIterator, load_mean_image
    from cxxnet_tpu_torch.io.data import DataInst
    from cxxnet_tpu_torch.io.iter_batch import BatchAdaptIterator
    from cxxnet_tpu_torch.io.iter_img import decode_image
    from cxxnet_tpu_torch.utils.binary_page import iter_page_blobs
    with open(os.path.join(tdir, "data", "train.bin"), "rb") as f:
        blobs = next(iter_page_blobs(f))[:512]
    n = len(blobs)
    t0 = time.perf_counter()
    imgs = [decode_image(b) for b in blobs]
    decode1 = n / (time.perf_counter() - t0)
    with ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode_image, blobs))
        decode4 = n / (time.perf_counter() - t0)
    insts = [DataInst(index=i, data=im, label=np.zeros(1, np.float32))
             for i, im in enumerate(imgs)]
    aug = AugmentIterator(ListIter(insts))
    for k, v in (("input_shape", "3,227,227"), ("rand_crop", "1"),
                 ("rand_mirror", "1")):
        aug.set_param(k, v)
    aug.meanimg = load_mean_image(os.path.join(tdir, "models",
                                               "image_net_mean.bin"))
    aug.before_first()
    out = []
    t0 = time.perf_counter()
    while aug.next():
        out.append(aug.value())
    augment = n / (time.perf_counter() - t0)
    batcher = BatchAdaptIterator(ListIter(out))
    batcher.set_param("batch_size", "256")
    batcher.before_first()
    t0 = time.perf_counter()
    while batcher.next():
        pass
    collate = n / (time.perf_counter() - t0)
    say(f"[host stages, images/s] decode {decode1:.1f} on one thread, "
        f"{decode4:.1f} on the pool of 4; host augment (AlexNet.conf's "
        f"spec, one thread) {augment:.1f}; batch collation {collate:.1f}; "
        f"os.cpu_count() {os.cpu_count()}; host clock; on {card}")
    return dict(decode_1_thread=decode1, decode_4_threads=decode4,
                augment=augment, collate=collate)


def phase_image_timing(torch, d: str, fmt: str, card: str):
    """(g): AlexNet b256 bfloat16 through NetTrainer and create_iterator
    on AlexNet.conf's own train block over 3,072 images (12 batches), in
    three settings: streamed (prefetch_stage = 0), prefetch_stage = 1,
    and prefetch_stage = 1 + device_augment = 1; beside them the device
    alone (one staged batch repeated) and the same 12 batches decoded
    once and held in memory, streamed and prefetched (the staging
    overlap without the iterator in the way)."""
    import shutil
    say("== phase 10g: AlexNet b256 bfloat16 training from imgbin: where "
        "the time goes ==")
    tdir = os.path.join(d, "timing")
    write_image_set(tdir, "data/resize256", "data/train", 3072, 256, 10, 41,
                    fmt)
    os.makedirs(os.path.join(tdir, "models"))
    shutil.copy(os.path.join(d, "alexnet", "models", "image_net_mean.bin"),
                os.path.join(tdir, "models", "image_net_mean.bin"))
    block = alexnet_train_block()
    results = {}
    tr = alexnet_trainer([])
    itr = make_iter(block, tdir)
    cached = pull(itr, 12)
    stop_iter(itr)
    stage = staging_ms(torch, tr, lambda: tr.stage_batch(cached[0]), 3)
    staged = tr.stage_batch(cached[0])
    for _ in range(2):
        tr.update(staged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        tr.update(staged)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) * 100.0
    del staged
    say(f"the step alone (one staged batch, repeated): {device_ms:.3f} ms, "
        f"{256 / device_ms * 1e3:.1f} images/s; staging one batch "
        f"{stage_txt(stage)}; on {card}")
    for label, prefetch in (("cached batches, streamed", False),
                            ("cached batches, prefetch_stage = 1", True)):
        step_ms, idle = timed_setting(torch, tr, ListIter(cached),
                                      prefetch)
        say_setting(results, label, step_ms, idle, device_ms, card)
    del cached
    tr = timed_settings(torch, tr, block, tdir, device_ms, card, results)
    del tr
    torch.cuda.empty_cache()
    results["host stages"] = host_stage_rates(tdir, card)
    results["step alone"] = dict(step_ms=device_ms,
                                   images_s=256 / device_ms * 1e3,
                                   staging_ms=stage["bfloat16"],
                                   staging_f32_ms=stage["float32"])
    say("phase 10g summary " + json.dumps(
        {k: {kk: (round(vv, 4) if vv == vv else None)
             for kk, vv in v.items()}
         for k, v in results.items()}))
    return results


def timed_settings(torch, tr, block, tdir, device_ms, card, results,
                   extra=(), device=None, tag=""):
    """10g's three settings of AlexNet.conf's train block over `tdir`'s
    set - streamed, prefetch_stage = 1, and prefetch_stage = 1 +
    device_augment = 1 - each with its staging time and the iterator's
    own rate; `extra` pairs and `device` reach create_iterator. Returns
    the trainer (the device_augment setting builds its own)."""
    settings = (("streamed (prefetch_stage = 0)", False, 0),
                ("prefetch_stage = 1", True, 0),
                ("prefetch_stage = 1 + device_augment = 1", True, 1))
    for label, prefetch, daug in settings:
        if daug:
            del tr
            torch.cuda.empty_cache()
            # the trainer reads the train block's image_mean
            # (models/image_net_mean.bin) relative to the working
            # directory, as in a CLI run from tdir
            keep = os.getcwd()
            os.chdir(tdir)
            try:
                tr = alexnet_trainer(["device_augment=1"])
                # the first augment loads (and caches) the mean image
                tr._model_input(torch.zeros((1, 3, 256, 256),
                                            dtype=torch.uint8,
                                            device=tr.device))
            finally:
                os.chdir(keep)
        pairs = list(extra) + ([("device_augment", "1")] if daug else [])
        itr = make_iter(block, tdir, pairs, device)
        b = pull(itr, 1)[0]
        stop_iter(itr)
        st = staging_ms(torch, tr, lambda: tr.stage_batch(b), 3)
        rate = iterator_rate(itr)
        step_ms, idle = timed_setting(torch, tr, itr, prefetch)
        stop_iter(itr)
        say_setting(results, tag + label, step_ms, idle, device_ms, card,
                    rate, st, "uint8" if daug else "bfloat16")
    return tr


def phase_image_pipeline(torch, card, cli_phases=(), then=None):
    """Phase 10: the image data pipeline on the card; then `then(d)`
    (phases 13-15) while phase 10's imgbin set under `d` still exists.
    The CLI runs of 10c, 10d, 11c (GoogLeNet.conf on the same set), 11d
    (stack_moe.conf) and `cli_phases`, functions of `d` (5, 7, 8c, 13f,
    14b-c, 15b and 15d) check and time nothing: they run side by side.
    Returns ((AlexNet's, GoogLeNet's and stack_moe's CLI launches, the
    cli_phases' results), 10g's timing, then's result)."""
    import scipy
    say("== phase 10a: environment of the image pipeline ==")
    fmt, pil = image_format_used()
    say(f"PIL: {'imports, version ' + pil if pil else 'not installed'}")
    say(f"scipy {scipy.__version__}")
    say(f"os.cpu_count() = {os.cpu_count()}")
    say(f"synthetic image format: {fmt}"
        + (" (quality 90, written with PIL)" if fmt == "JPEG"
           else " (binary P6, written with numpy)"))
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        say("== phase 10b: synthetic imgbin sets ==")
        shared = os.path.join(d, "shared")
        write_image_set(shared, "data/resize256", "data/train", 512, 256,
                        10, 11, fmt)
        write_image_set(shared, "data/resize256_test", "data/test", 256,
                        256, 10, 12, fmt)
        # AlexNet.conf names image_root ./data/resize256/ for both blocks;
        # imgbin reads the packed .bin and never opens the loose files
        say(f"512 train + 256 test images, 256 x 256 {fmt}, packed with "
            f"cxxnet_tpu_torch.tools.im2bin in "
            f"{time.perf_counter() - t10:.1f} s")
        counts = side_by_side(lambda: phase_alexnet_cli(d),
                              lambda: phase_image_confs_cli(d, fmt),
                              lambda: phase_googlenet_cli(d),
                              phase_stack_moe_cli,
                              *(lambda fn=fn: fn(d) for fn in cli_phases))
        counts = (counts[0], counts[2], counts[3], counts[4:])
        phase_staged_vs_streamed(torch, d)
        phase_device_augment_vs_host(torch, d)
        timing = run_leg(torch, "10g", d, fmt)
        say(f"phase 10 took {time.perf_counter() - t10:.1f} s")
        after = then(d) if then is not None else None
    return counts, timing, after


# ---------------------------------------------------------------------------
# decoder facts: what a native or nvJPEG image decoder could build on
# ---------------------------------------------------------------------------

def decoder_facts() -> str:
    """Which of jpeglib.h, png.h, nvjpeg.h, libnvjpeg and g++ this
    machine has: the system and CUDA include / library directories and
    the NVIDIA wheels beside torch are looked at; nothing is built."""
    import glob
    import shutil
    import site
    incs = ["/usr/include", "/usr/local/include",
            "/usr/include/x86_64-linux-gnu", "/usr/local/cuda/include"]
    libs = ["/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/local/lib",
            "/usr/local/cuda/lib64",
            "/usr/local/cuda/targets/x86_64-linux/lib"]
    for sp in site.getsitepackages():
        incs += glob.glob(os.path.join(sp, "nvidia", "*", "include"))
        libs += glob.glob(os.path.join(sp, "nvidia", "*", "lib"))

    def find(dirs, pattern):
        for dr in dirs:
            hits = sorted(glob.glob(os.path.join(dr, pattern)))
            if hits:
                return hits[0]
        return None
    facts = {
        "jpeglib.h": find(incs, "jpeglib.h"),
        "png.h": find(incs, "png.h") or find(incs, "libpng*/png.h"),
        "nvjpeg.h": find(incs, "nvjpeg.h"),
        "libnvjpeg": find(libs, "libnvjpeg.so*"),
        "g++": shutil.which("g++"),
    }
    return "; ".join(f"{k}: {v or 'absent'}" for k, v in facts.items())


# ---------------------------------------------------------------------------
# phase 11: GoogLeNet.conf and stack_moe.conf (the last layer types)
# ---------------------------------------------------------------------------

GOOGLENET_CONF = os.path.join(IMAGENET_CONFS, "GoogLeNet.conf")
STACK_CONF = os.path.join(REPO, "examples", "LongSeq", "stack_moe.conf")
# GoogLeNet.conf's two LRN inputs at its batch of 256: n1 (after pool1)
# and n2 (after conv2), local_size 5, alpha 1e-4
GOOGLENET_B256_LRN = ((256, 64, 56, 56), (256, 192, 56, 56))
GOOGLENET_ALPHA = 0.0001
# GoogLeNet.conf's test block again, as a pred block
GOOGLENET_PRED_BLOCK = """
pred = pred.txt
iter = imgbin
  image_list = "./data/test.lst"
  image_bin = "./data/test.bin"
  image_mean = "models/image_net_mean.bin"
iter = end
"""


def phase_googlenet_lrn(torch, card):
    """11a (a leg, in a process of its own): K1-fwd and K1-bwd at
    GoogLeNet's b256 LRN shapes, float32 and bfloat16, against their
    plain versions (phase 3 / 3b's bars), with the plan, warm-L2 times,
    device time and the byte bound. Returns (max abs errors, a list of
    [kernel, shape, dtype name, times])."""
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops.lrn import (
        lrn, lrn_backward, lrn_bwd_reference, lrn_plan, lrn_reference)
    say("== phase 11a: K1-fwd and K1-bwd at GoogLeNet.conf's LRN shapes "
        "(b256, local_size 5) ==")
    alpha, beta, knorm, n = GOOGLENET_ALPHA, 0.75, 1.0, 5
    gen = torch.Generator(device="cuda").manual_seed(77)
    rows, max_err = [], {"lrn_fwd": 0.0, "lrn_bwd": 0.0}
    for shape in GOOGLENET_B256_LRN:
        for dt in (torch.bfloat16, torch.float32):
            x = lrn_input(torch, gen, shape, dt, False)
            g = lrn_input(torch, gen, shape, dt, False, scale=1.0)
            got = lrn(x, n, alpha, beta, knorm)
            ref = lrn_reference(x, n, alpha, beta, knorm)
            ok = (torch.allclose(got, ref, rtol=1e-5, atol=1e-6)
                  if dt == torch.float32 else bf16_ulp_close(torch, got, ref))
            err = float((got.float() - ref.float()).abs().max())
            gin = lrn_backward(x, g, n, alpha, beta, knorm)
            bok, berr = lrn_bwd_close(torch, gin, x, g, n, alpha, beta, knorm)
            if not (ok and bok):
                raise AssertionError(
                    f"K1 at GoogLeNet's {shape} {dt}: forward ok={ok} "
                    f"({err:.3e}), backward ok={bok} ({berr:.3e})")
            max_err["lrn_fwd"] = max(max_err["lrn_fwd"], err)
            max_err["lrn_bwd"] = max(max_err["lrn_bwd"], berr)
            for name, bw in (("lrn_fwd", False), ("lrn_bwd", True)):
                p = lrn_plan(shape, n, dt, bw)
                if bw:
                    bound, by = lrn_bwd_bound_ms(shape, x.element_size(), n)
                    xl = x.detach().float().requires_grad_(True)
                    y = F.local_response_norm(xl, n, alpha, beta, knorm)

                    def kern():
                        return lrn_backward(x, g, n, alpha, beta, knorm)

                    def plain():
                        return lrn_bwd_reference(x, g, n, alpha, beta, knorm)

                    def library():
                        return torch.autograd.grad(y, xl, g.float(),
                                                   retain_graph=True)
                else:
                    bound, by = lrn_bound_ms(shape, x.element_size(), n)

                    def kern():
                        return lrn(x, n, alpha, beta, knorm)

                    def plain():
                        return lrn_reference(x, n, alpha, beta, knorm)

                    def library():
                        return F.local_response_norm(x, n, alpha, beta, knorm)
                t = {"kernel": time_warm(torch, kern, 20),
                     "kernel_device": lrn_device_ms(
                         torch, kern, f"{name}_kernel", 10, strict=True),
                     "plain": time_warm(torch, plain, 5),
                     "library": time_warm(torch, library, 5)}
                rows.append([name, shape, str(dt)[6:],
                             dict(t, bound=bound, by=by)])
                say(f"{name} {shape} {str(dt)[6:]}: max abs err "
                    f"{berr if bw else err:.3e}; plan chunk {p['chunk']}, "
                    f"segment {p['seg']} "
                    f"({'whole H*W' if p['whole'] else 'rows'}), "
                    f"{p['threads']} threads, {p['smem_bytes']} B shared, "
                    f"{p['blocks']} blocks; warm L2 {t['kernel']:.4f} ms, "
                    f"device time {t['kernel_device']:.4f} ms (profiler), "
                    f"plain {t['plain']:.4f} ms, "
                    f"{'backward of ' if bw else ''}local_response_norm"
                    f"{' (float32)' if bw else ''} {t['library']:.4f} ms; "
                    f"bound {bound:.4f} ms ({by}): "
                    f"{bound / t['kernel']:.0%} of it reached (warm)")
                if bw:
                    del y, xl
            del x, g, got, ref, gin
    torch.cuda.empty_cache()
    return max_err, rows


def phase_googlenet_step(torch, card):
    """11b (a leg, in a process of its own): GoogLeNet.conf unedited
    (b256, bfloat16) on one staged batch, 2 + 5 timed steps, a profile;
    then a float32 step card vs CPU."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    say("== phase 11b: examples/ImageNet/GoogLeNet.conf trained at full "
        "width (b256, bfloat16) ==")
    tr = conf_trainer(GOOGLENET_CONF, [])
    if (tr.compute_dtype != torch.bfloat16 or str(tr.device) != "cuda:0"
            or tr.batch_size != 256):
        raise AssertionError(f"GoogLeNet.conf should train b256 bfloat16 "
                             f"on cuda:0, got b{tr.batch_size} "
                             f"{tr.compute_dtype} on {tr.device}")
    rng = np.random.RandomState(17)
    images = (rng.rand(256, 3, 224, 224) * 255.0 - 128.0).astype(np.float32)
    labels = rng.randint(0, 1000, size=(256, 1)).astype(np.float32)
    batch = DataBatch(data=images, label=labels)
    per_step = {"lrn_fwd": 2, "lrn_bwd": 2}
    staged = tr.stage_batch(batch)
    counts, step_ms, peak = train_steps(torch, tr, batch, per_step,
                                        timed=5, staged=staged)
    say(f"GoogLeNet b256 bfloat16 training step: {step_ms:.3f} ms (host "
        f"clock over 5 steps on one staged batch, CUDA-synchronised), "
        f"{256 / step_ms * 1e3:.1f} images/s; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; K1 launches {counts['lrn_fwd']} "
        f"forward, {counts['lrn_bwd']} backward in 7 steps; on {card}")
    profiled = profile_steps(torch, lambda: tr.update(staged), 3,
                             strict=True)
    say_profile(profiled, 3, card)
    _, groups, busy, window = profiled
    ties = groups["max-pool ties backward"]
    k1 = groups["lrn_fwd kernel"] + groups["lrn_bwd kernel"]
    result = {"step_ms": step_ms, "images_s": 256 / step_ms * 1e3,
              "peak_gib": peak / 2 ** 30, "counts": counts,
              "idle": 1 - busy / window, "ties_ms": ties, "k1_ms": k1,
              "device_ms": busy / 3}
    say(f"GoogLeNet step: ties max-pool backward {ties:.3f} ms and K1 "
        f"{k1:.4f} ms of device time per step, of "
        f"{busy / 3:.3f} ms busy in a {window / 3:.3f} ms traced step "
        f"(ties share of the device time "
        f"{ties / (busy / 3):.3f}) on {card}")
    del tr, staged
    torch.cuda.empty_cache()
    say("== phase 11b: a float32 GoogLeNet step, card vs CPU ==")
    f32_step_card_vs_cpu(
        torch, lambda o: conf_trainer(GOOGLENET_CONF, o), images, labels,
        per_step)
    return result


def phase_googlenet_cli(d: str):
    """11c: GoogLeNet.conf through the CLI on phase 10's imgbin set: 2
    rounds, continue = 1 for a third, task = pred (one line per test
    image). Returns the kernel launches of the 2 rounds."""
    say("== phase 11c: examples/ImageNet/GoogLeNet.conf through the CLI "
        "on imgbin data (b256, bfloat16, full width) ==")
    gdir = os.path.join(d, "googlenet")
    os.makedirs(gdir)
    os.symlink(os.path.join(d, "shared", "data"), os.path.join(gdir, "data"))
    mets, counts, _ = cli_train_checked(GOOGLENET_CONF, gdir, 2,
                                        "GoogLeNet.conf")
    if counts.get("lrn_fwd", 0) <= 0 or counts.get("lrn_bwd", 0) <= 0:
        raise AssertionError(f"GoogLeNet.conf CLI training launched {counts}")
    proc = run_cli([GOOGLENET_CONF, "continue=1", "num_round=3",
                    "max_round=3"], cwd=gdir)
    got = round_metrics(proc.stderr)
    if sorted(got) != [3] or not os.path.exists(
            os.path.join(gdir, "models", "0003.model")):
        raise AssertionError(f"continue=1 should train round 3 only:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    say(f"continue=1 num_round=3: resumed, round 3 {got[3]}")
    pconf = os.path.join(gdir, "googlenet_pred.conf")
    with open(GOOGLENET_CONF) as f, open(pconf, "w") as g:
        g.write(f.read() + GOOGLENET_PRED_BLOCK)
    run_cli([pconf, "task=pred", "model_in=models/0003.model"], cwd=gdir)
    with open(os.path.join(gdir, "pred.txt")) as f:
        preds = f.read().split()
    if len(preds) != 256:
        raise AssertionError(f"task=pred wrote {len(preds)} lines")
    say(f"task=pred: {len(preds)} lines, one per test image, "
        f"{len(set(preds))} distinct classes")
    return counts


def phase_stack_moe_cli():
    """11d, the CLI: stack_moe.conf unedited for 2 rounds on synthetic
    MNIST-format data under ./data/, then task = pred."""
    say("== phase 11d: examples/LongSeq/stack_moe.conf through the CLI ==")
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "data"))
        write_mnist(os.path.join(d, "data"), 1000, 3, "train")
        write_mnist(os.path.join(d, "data"), 300, 4, "t10k")
        conf = os.path.join(d, "stack_moe.conf")
        with open(STACK_CONF) as f:
            text = f.read()
        with open(conf, "w") as f:
            f.write(text + SEQ_PRED_BLOCK.format(out="pred.txt"))
        mets, counts, _ = cli_train_checked(conf, d, 2, "stack_moe.conf")
        if any(counts.get(n, 0) <= 0 for n in K2):
            raise AssertionError(f"stack_moe.conf CLI launched {counts}")
        run_cli([conf, "task=pred", "model_in=models/0002.model"], cwd=d)
        with open(os.path.join(d, "pred.txt")) as f:
            preds = f.read().split()
        if len(preds) != 300:
            raise AssertionError(f"task=pred wrote {len(preds)} lines")
        say(f"task=pred: {len(preds)} lines, one per test image")
    return counts


def phase_stack_moe(torch, card):
    """11d on the card (a leg, in a process of its own): b100 bfloat16
    steps (K2's launches per step), a profile, the Server burst (K2-fwd
    launches per served batch) and a float32 step card vs CPU with the
    moe aux term."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    say("== phase 11d: examples/LongSeq/stack_moe.conf trained and served "
        "on the card ==")
    tr = conf_trainer(STACK_CONF, [])
    if (tr.compute_dtype != torch.bfloat16 or str(tr.device) != "cuda:0"
            or tr.batch_size != 100):
        raise AssertionError(f"stack_moe.conf should train b100 bfloat16 "
                             f"on cuda:0, got b{tr.batch_size} "
                             f"{tr.compute_dtype} on {tr.device}")
    rng = np.random.RandomState(23)
    images = rng.rand(100, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=(100, 1)).astype(np.float32)
    batch = DataBatch(data=images, label=labels)
    per_step = {n: 4 for n in K2}
    step_counts, step_ms, peak = train_steps(torch, tr, batch, per_step)
    say(f"stack_moe b100 bfloat16 training step: {step_ms:.3f} ms (host "
        f"clock over 10 steps), {100 / step_ms * 1e3:.1f} images/s; peak "
        f"memory {peak / 2 ** 20:.1f} MiB; K2 launches {step_counts} in 12 "
        f"steps = 4 each per step (4 stacked blocks); on {card}")
    profiled = profile_steps(torch, lambda: tr.update(batch), 5, SEQ_GROUPS,
                             strict=True)
    say_profile(profiled, 5, card)
    launches, batches, stats = serve_burst(torch, card, tr, 4,
                                           "stack_moe.conf")
    del tr
    torch.cuda.empty_cache()
    say("== phase 11d: a float32 stack_moe step (moe aux on), card vs CPU "
        "==")
    f32_step_card_vs_cpu(torch, lambda o: conf_trainer(STACK_CONF, o),
                         images, labels, per_step)
    return {"step_counts": step_counts, "step_ms": step_ms,
            "serve_launches": launches, "serve_batches": batches,
            "serve": stats}


# ---------------------------------------------------------------------------
# phase 12: the serving front on the card (HTTP /predict, shedding,
# deadlines, hot-swap, canary, drain) - run as a fresh-process leg
# ---------------------------------------------------------------------------

# the ingress cap of phase 12's listener: a /predict body of 8 AlexNet
# rows is ~25 MB of JSON text
FRONT_MAX_BODY = 64 << 20


class DefaultStreamLane:
    """The Server's dispatch as it was before the per-replica lanes
    (phase 4's old path): rows staged from pageable memory on the
    default stream, the forward there, `.cpu()` as the sync point. A
    measuring baseline of this script, swapped into a Server's lanes."""

    def __init__(self, tr):
        self.trainer = tr

    def run(self, graph, cparams, data, extras=()):
        tr = self.trainer
        out = graph.run(cparams, tr.stage_infer_rows(data),
                        tr.stage_extras(extras))
        return out.reshape(data.shape[0], -1).cpu().numpy()


def phase4_requests(np):
    """Phase 4's (and 9b's) 30 requests of 1-64 AlexNet rows."""
    rng = np.random.RandomState(11)
    sizes = [int(s) for s in rng.randint(1, 65, size=30)]
    sizes[0], sizes[1] = 64, 1
    return [(rng.rand(s, 3, 227, 227) * 255.0 - 128.0).astype(np.float32)
            for s in sizes]


def post_json(port, body: bytes, timeout=300):
    """POST /predict: (status, headers, decoded JSON body)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=body)
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def get_status(url: str) -> int:
    import urllib.error
    import urllib.request
    try:
        return urllib.request.urlopen(url, timeout=30).status
    except urllib.error.HTTPError as e:
        return e.code


def wait_for(pred, secs: float) -> bool:
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def burst_line(label, stats, rows, wall, card):
    say(f"[{label}] {rows / wall:.1f} rows/s; latency p50 "
        f"{stats['latency_p50_ms']} / p99 {stats['latency_p99_ms']} ms, "
        f"queue p50 {stats['queue_p50_ms']} / p99 {stats['queue_p99_ms']} "
        f"ms, device p50 {stats['device_p50_ms']} / p99 "
        f"{stats['device_p99_ms']} ms; {stats['batches']} batches (host "
        f"clock; 30 requests of 1-64 rows from 2 threads, max_batch 64, "
        f"2 replicas, bfloat16) on {card}")
    return dict(rows_s=rows / wall, **{
        k: stats[k] for k in ("latency_p50_ms", "latency_p99_ms",
                              "queue_p50_ms", "queue_p99_ms",
                              "device_p50_ms", "device_p99_ms",
                              "batches")})


def front_in_process(torch, card, tr, reqs):
    """12a: phase 4's burst through the front's lanes (a stream and a
    pinned buffer per replica) and through the old default-stream path, on
    the same requests in the order new, old, old, new; the front's K1-fwd
    launches; the device's idle share over one profiled burst."""
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.serve import Server
    say("== phase 12a: AlexNet.conf in process: the front's lanes against "
        "the default-stream path ==")
    srv = Server(tr, max_batch=64, replicas=2)
    say(f"buckets {list(srv.buckets)}; warmup {srv.warmup():.3f} s "
        f"(every bucket on both lanes)")
    lanes = srv._lanes
    old = [DefaultStreamLane(tr)] * 2
    rows = sum(r.shape[0] for r in reqs)
    out = {"front": [], "default_stream": []}
    results = None
    launches = batches = 0
    for label in ("front", "default_stream", "default_stream", "front"):
        srv._lanes = lanes if label == "front" else old
        # per-run percentiles: fresh latency windows for each burst
        srv._lat, srv._qlat, srv._dlat = (type(srv._lat)() for _ in range(3))
        before = srv.stats()["batches"]
        kernels.reset_launches()
        got, stats, wall = served_run(torch, srv, reqs)
        n = kernels.launches()["lrn_fwd"]
        stats["batches"] -= before
        if n != 2 * stats["batches"]:
            raise AssertionError(f"lrn_fwd launched {n} times over "
                                 f"{stats['batches']} batches; AlexNet runs "
                                 "it twice a batch")
        out[label].append(burst_line(label, stats, rows, wall, card))
        if label == "front":
            results = got
            launches += n
            batches += stats["batches"]
    worst, _rel, undecided, _fl = check_bf16_rows(tr, reqs, results)
    say(f"front rows vs predict_dist: max abs {worst:.3e} (rtol "
        f"{BF16_RTOL}, atol {BF16_ATOL}), argmax identical on "
        f"{rows - undecided}/{rows} decided rows; lrn_fwd {launches} "
        f"launches = 2 x {batches} batches over the two front bursts")
    srv._lanes = lanes
    profiled = profile_steps(torch, lambda: served_run(torch, srv, reqs), 1,
                             INT8_GROUPS, strict=True)
    _rows, groups, busy_ms, window_ms = profiled
    idle = 1 - busy_ms / window_ms
    say(f"one front burst profiled: device busy {busy_ms:.3f} ms of "
        f"{window_ms:.3f} ms traced, idle share {idle:.4f}; K1-fwd "
        f"{groups['lrn_fwd kernel']:.3f} ms device time (torch.profiler) "
        f"on {card}")
    return dict(out, idle=idle, lrn_fwd=launches, batches=batches)


def front_http(torch, card, tr, reqs):
    """12b: /predict from a pool of 4 client threads, 24 requests of 1-8
    rows (JSON bodies encoded before the clock starts; the server's
    parse of 154,587 floats a row is part of what is timed); 200 rows
    against predict_dist at the bfloat16 bar; /metrics through
    validate_exposition; an over-size body's 413."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.serve import Server
    from cxxnet_tpu_torch.telemetry.http import validate_exposition
    say("== phase 12b: AlexNet.conf over HTTP /predict ==")
    srv = Server(tr, max_batch=64, replicas=2, http_port=0,
                 metrics_host="127.0.0.1", max_body_bytes=FRONT_MAX_BODY)
    srv.warmup()
    srv.start()
    port = srv.metrics_server.port
    rng = np.random.RandomState(12)
    data = [(rng.rand(int(n), *tr.net_cfg.input_shape) * 255.0 - 128.0).astype(
        np.float32) for n in rng.randint(1, 9, size=24)]
    bodies = [json.dumps({"data": d.reshape(d.shape[0], -1).tolist(),
                          "raw": True}).encode() for d in data]
    lat = []

    def one(i):
        t0 = time.perf_counter()
        got = post_json(port, bodies[i])
        lat.append((time.perf_counter() - t0) * 1e3)
        return got

    kernels.reset_launches()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        answers = list(pool.map(one, range(len(bodies))))
    wall = time.perf_counter() - t0
    launches = kernels.launches()["lrn_fwd"]
    stats = srv.stats()
    if launches != 2 * stats["batches"]:
        raise AssertionError(f"lrn_fwd launched {launches} times over "
                             f"{stats['batches']} batches over HTTP")
    bad = [(c, b) for c, _h, b in answers if c != 200]
    if bad:
        raise AssertionError(f"/predict answered {bad[0]}")
    outs = [np.asarray(b["outputs"], np.float32) for _c, _h, b in answers]
    worst, _rel, undecided, _fl = check_bf16_rows(tr, data, outs)
    rows = sum(d.shape[0] for d in data)
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    say(f"[http] {rows} rows in {len(data)} requests: {rows / wall:.1f} "
        f"rows/s, {len(data) / wall:.2f} requests/s; client latency p50 "
        f"{p50:.1f} / p99 {p99:.1f} ms (host clock, JSON parse of the "
        f"bodies included); server queue p50 {stats['queue_p50_ms']} / "
        f"p99 {stats['queue_p99_ms']} ms, device p50 "
        f"{stats['device_p50_ms']} / p99 {stats['device_p99_ms']} ms; "
        f"{stats['batches']} batches; 4 client threads on {card}")
    say(f"http rows vs predict_dist: max abs {worst:.3e}, argmax identical "
        f"on {rows - undecided}/{rows} decided rows")
    metrics = urllib_get(f"http://127.0.0.1:{port}/metrics")
    problems = validate_exposition(metrics)
    if problems or "cxxnet_serve_requests_total" not in metrics:
        raise AssertionError(f"/metrics: {problems[:3]}")
    with socket_conn(port) as s:
        s.sendall(b"POST /predict HTTP/1.0\r\nContent-Length: "
                  + str(FRONT_MAX_BODY + 1).encode() + b"\r\n\r\n")
        head = s.recv(4096).split(b"\r\n")[0]
    if b"413" not in head:
        raise AssertionError(f"an over-size body answered {head!r}")
    say(f"/metrics passes validate_exposition ({len(metrics)} bytes); a "
        f"{FRONT_MAX_BODY + 1}-byte body answers {head.decode()}")
    return srv, dict(rows_s=rows / wall, requests_s=len(data) / wall,
                     client_p50_ms=p50, client_p99_ms=p99,
                     lrn_fwd=launches, batches=stats["batches"],
                     **{k: stats[k] for k in ("queue_p50_ms", "queue_p99_ms",
                                              "device_p50_ms",
                                              "device_p99_ms")})


def urllib_get(url: str) -> str:
    import urllib.request
    return urllib.request.urlopen(url, timeout=60).read().decode()


def socket_conn(port):
    import socket
    return socket.create_connection(("127.0.0.1", port), timeout=60)


def front_shed_deadline(srv, reqs):
    """12c: a storm past queue_limit gets 429 + Retry-After in [1, 60]
    while /healthz reads 503, then 200 once the queue has drained for
    serve_shed_clear_ms; a deadline shorter than the stalled dispatch
    ahead of it answers 504."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from cxxnet_tpu_torch.utils import fault
    say("== phase 12c: shedding and deadlines over HTTP ==")
    port = srv.metrics_server.port
    health = f"http://127.0.0.1:{port}/healthz"
    one = json.dumps({"data": reqs[1].reshape(1, -1).tolist()}).encode()
    srv.queue_limit, srv.shed_clear_ms = 4, 500.0
    fault.clear()
    for i in range(16):
        fault.inject("serve_dispatch_delay", "delay", "0.5", at=i + 1)
    during = []
    stop = threading.Event()

    def poll():
        while not stop.wait(0.05):
            during.append(get_status(health))

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        with ThreadPoolExecutor(16) as pool:
            answers = list(pool.map(lambda _i: post_json(port, one),
                                    range(16)))
    finally:
        stop.set()
        poller.join(timeout=60)
    codes = [c for c, _h, _b in answers]
    if 503 not in during:
        raise AssertionError(f"/healthz during the storm: {during}")
    shed = [h for c, h, _b in answers if c == 429]
    if 429 not in codes or 200 not in codes or set(codes) - {200, 429}:
        raise AssertionError(f"storm answered {codes}")
    retry = [int(h["Retry-After"]) for h in shed]
    if not all(1 <= r <= 60 for r in retry):
        raise AssertionError(f"Retry-After {retry}")
    fault.clear()
    t_clear = time.monotonic()
    if not wait_for(lambda: get_status(health) == 200, 30.0):
        raise AssertionError("/healthz never recovered after the storm")
    recovered_s = time.monotonic() - t_clear
    srv.queue_limit = 0
    say(f"storm of 16 one-row requests past queue_limit 4 (dispatches "
        f"stalled 0.5 s): {codes.count(200)} x 200, {len(shed)} x 429 with "
        f"Retry-After {sorted(set(retry))} s; /healthz "
        f"{sorted(set(during))} during it, 200 {recovered_s:.2f} s after "
        f"(serve_shed_clear_ms 500)")
    # both replicas stalled on a full bucket each; the request behind
    # them waits past its deadline in the queue. Its body (3 MB of JSON)
    # is made before the stalls, which outlast its send and its parse on
    # a slow host: a 0.5 s stall could end before the request was queued
    payload = json.dumps({"data": reqs[1].reshape(1, -1).tolist(),
                          "deadline_ms": 50}).encode()
    fault.inject("serve_dispatch_delay", "delay", "2.0", at=1)
    fault.inject("serve_dispatch_delay", "delay", "2.0", at=2)
    blockers = [srv.submit(reqs[0]) for _ in range(2)]
    if not wait_for(lambda: srv._queued_rows == 0, 10.0):
        raise AssertionError("the blockers never left the queue")
    time.sleep(0.05)
    code, _h, body = post_json(port, payload)
    for b in blockers:
        b.result(timeout=60)
    fault.clear()
    if code != 504:
        raise AssertionError(f"a 50 ms deadline behind a 2 s dispatch "
                             f"answered {code}: {body}")
    say(f"deadline_ms 50 behind two stalled dispatches: {code} "
        f"({body['error'][:60]})")
    return dict(storm_codes=codes, retry_after=retry, healthz=during,
                recovered_s=recovered_s, deadline_code=code)


def front_swap(srv, tr, tr_new, published, reqs):
    """12d: a hot-swap mid-storm from a checkpoint published with
    publish_model: no request dropped, every response the old or the
    new weights' rows (bfloat16 bar), one switch, the bucket programs
    flat."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet import checkpoint
    say("== phase 12d: hot-swap mid-storm ==")
    rng = np.random.RandomState(14)
    data = [(rng.rand(int(n), *tr.net_cfg.input_shape) * 255.0 - 128.0).astype(
        np.float32) for n in rng.randint(1, 17, size=40)]

    def ref(t, d):
        return t.predict_dist(DataBatch(
            data=d, label=np.zeros((d.shape[0], 1), np.float32)))
    old_refs = [ref(tr, d) for d in data]
    new_refs = [ref(tr_new, d) for d in data]
    n_prog = srv.executable_cache_size()
    meta = checkpoint.read_publish_meta(published)
    # 20 requests queued, the swap while the replicas drain them, then
    # 20 more: the first 20 are the old or the new weights' rows, every
    # later one the new
    futs = [srv.submit(d) for d in data[:20]]
    if not wait_for(futs[0].done, 60.0):
        raise AssertionError("the first request never resolved")
    ok = srv.swap_to(published)
    futs += [srv.submit(d) for d in data[20:]]
    outs = [f.result(timeout=300) for f in futs]
    sides = []
    for o, a, b in zip(outs, old_refs, new_refs):
        near = [bool(np.allclose(o, r, rtol=BF16_RTOL, atol=BF16_ATOL))
                for r in (a, b)]
        if near == [False, False] or near == [True, True]:
            raise AssertionError(f"a response matches old {near[0]} / new "
                                 f"{near[1]} weights")
        sides.append(0 if near[0] else 1)
    stats = srv.stats()
    if (not ok or stats["swaps"] != 1 or stats["errors"]
            or 0 not in sides or not all(sides[20:]) or srv.executable_cache_size()
            != n_prog):
        raise AssertionError(f"swap: applied {ok}, swaps "
                             f"{stats['swaps']}, errors {stats['errors']}, "
                             f"sides {sides}")
    say(f"swap from {os.path.basename(published)} (provenance src "
        f"{os.path.basename(meta['src'])}): 40 requests, 0 dropped, "
        f"{sides.count(0)} answered by the old weights, {sides.count(1)} "
        f"by the new (all 20 submitted after the swap); bucket programs "
        f"{n_prog} before and after")
    return dict(old=sides.count(0), new=sides.count(1))


def scaled_candidate(tr, d, name, factor):
    """Save `tr`'s weights with fc8's scaled by `factor` (the argmax
    unchanged, the probabilities sharpened) and publish them; returns
    the published path."""
    from cxxnet_tpu_torch.nnet import checkpoint
    w, shape = tr.get_weight("fc8", "wmat")
    keep = w.copy()
    tr.set_weight(w * factor, "fc8", "wmat")
    src = os.path.join(d, f"{name}.model")
    with open(src, "wb") as fo:
        tr.save_model(fo)
    tr.set_weight(keep, "fc8", "wmat")
    pub = os.path.join(d, f"{name}.published.model")
    checkpoint.publish_model(src, pub)
    return pub


def drive_canary(srv, reqs, key: str, secs: float = 60.0):
    """Submit phase 4's requests round robin until stats()[key] moves."""
    futs = []
    i = 0
    deadline = time.monotonic() + secs
    while not srv.stats()[key] and time.monotonic() < deadline:
        futs.append(srv.submit(reqs[2 + i % 8]))
        i += 1
        if len(futs) > 8:
            futs.pop(0).result(timeout=300)
    for f in futs:
        f.result(timeout=300)
    return i


def front_canary(torch, srv, tr_new, d, reqs):
    """12e: a candidate (fc8 x 1.05) promoted after its window; one
    (fc8 x 1.1) with canary_divergence injected rolled back, the
    incumbent slot untouched bitwise."""
    import numpy as np
    from cxxnet_tpu_torch.utils import fault
    say("== phase 12e: canary promote and rollback ==")
    srv.canary_frac, srv.canary_window = 0.5, 2.0
    probe = reqs[1]
    before = srv.submit(probe).result(timeout=300)
    good = scaled_candidate(tr_new, d, "cand_good", 1.05)
    if srv.swap_to(good) is not True:
        raise AssertionError("the canary did not start")
    n = drive_canary(srv, reqs, "canary_promoted")
    stats = srv.stats()
    after = srv.submit(probe).result(timeout=300)
    if (stats["canary_promoted"] != 1 or stats["canary_requests"] == 0
            or stats["canary_rolled_back"] or np.array_equal(before, after)):
        raise AssertionError(f"canary promote: {stats}")
    say(f"candidate fc8 x 1.05 promoted after {n} requests "
        f"({stats['canary_requests']} routed to it); the probe's top "
        f"probability {before.max():.4f} -> {after.max():.4f}, top class "
        f"{'kept' if before.argmax() == after.argmax() else 'changed'}")
    inc = srv._slot
    bits = {lk: {pn: t.clone() for pn, t in dd.items()}
            for lk, dd in inc.cparams.items()}
    bad = scaled_candidate(tr_new, d, "cand_bad", 1.1)
    fault.clear()
    for i in range(200):
        fault.inject("canary_divergence", "corrupt", at=i + 1)
    if srv.swap_to(bad) is not True:
        raise AssertionError("the second canary did not start")
    n = drive_canary(srv, reqs, "canary_rolled_back")
    fault.clear()
    stats = srv.stats()
    again = srv.submit(probe).result(timeout=300)
    same = srv._slot is inc and all(
        torch.equal(t, bits[lk][pn]) for lk, dd in inc.cparams.items()
        for pn, t in dd.items())
    if (stats["canary_rolled_back"] != 1 or stats["swaps"] != 2 or not same
            or not np.allclose(again, after, rtol=BF16_RTOL,
                               atol=BF16_ATOL)):
        raise AssertionError(f"canary rollback: {stats}, incumbent "
                             f"untouched {same}")
    say(f"candidate fc8 x 1.1 with canary_divergence rolled back after {n} "
        f"requests; incumbent slot bitwise unchanged; the probe's rows "
        f"after it {float(np.abs(again - after).max()):.3e} max abs from "
        "before")
    srv.canary_frac = 0.0
    return dict(promoted=1, rolled_back=1)


def front_int8(torch, card, reqs):
    """12f: a second Server on the int8 graph (quantize_int8 calibrated
    on phase 9's first batch) serves 4 /predict requests: K3 11 times
    and K1-fwd twice a batch, rows at the bfloat16 bar."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.serve import Server
    say("== phase 12f: the int8 graph behind /predict ==")
    tr8 = alexnet_trainer([f"graph_passes={INT8_PASSES}"])
    tr8.calibrate_graph_passes(DataBatch(
        data=reqs[0], label=np.zeros((64, 1), np.float32)))
    srv = Server(tr8, max_batch=64, replicas=2, http_port=0,
                 metrics_host="127.0.0.1", max_body_bytes=FRONT_MAX_BODY)
    srv.warmup()
    data = [r[:n] for r, n in zip(reqs[2:6], (1, 3, 8, 5))]
    bodies = [json.dumps({"data": x.reshape(x.shape[0], -1).tolist(),
                          "raw": True}).encode() for x in data]
    kernels.reset_launches()
    srv.start()
    try:
        answers = [post_json(srv.metrics_server.port, b) for b in bodies]
    finally:
        stats = srv.stop()
    counts = kernels.launches()
    if any(c != 200 for c, _h, _b in answers):
        raise AssertionError(f"int8 /predict answered "
                             f"{[c for c, _h, _b in answers]}")
    b = stats["batches"]
    if (counts["int8_mm"] != K3_PER_ALEXNET_BATCH * b
            or counts["lrn_fwd"] != 2 * b or b == 0):
        raise AssertionError(f"int8 front launches {counts} over {b} "
                             "batches")
    outs = [np.asarray(bd["outputs"], np.float32) for _c, _h, bd in answers]
    worst, *_ = check_bf16_rows(tr8, data, outs)
    say(f"4 requests, {b} batches: int8_mm {counts['int8_mm']} = "
        f"{K3_PER_ALEXNET_BATCH} x {b}, lrn_fwd {counts['lrn_fwd']}; rows vs "
        f"predict_dist max abs {worst:.3e} on {card}")
    return dict(int8_mm=counts["int8_mm"], lrn_fwd=counts["lrn_fwd"],
                batches=b)


def front_cli(torch):
    """12g: task = serve through the CLI with serve_port, metrics_port and
    serve_rows = 0 on phase 5's data (2,000 rows, each dispatch stalled
    50 ms through CXXNET_FAULT so that the run stays live): /metrics
    scraped while it serves, /predict answered, then SIGTERM - the run
    drains and exits 0, and every row it admitted is in its output,
    equal to task = pred's lines."""
    import signal
    import socket
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.telemetry.http import validate_exposition
    say("== phase 12g: task = serve through the CLI, scraped, then "
        "SIGTERM ==")
    with tempfile.TemporaryDirectory() as d:
        write_mnist(d, 2000, 4)
        conf = os.path.join(d, "net.conf")
        with open(conf, "w") as f:
            f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d))
        tr = NetTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d))
        tr.init_model()
        model = os.path.join(d, "0001.model")
        with open(model, "wb") as fo:
            tr.save_model(fo)
        want = os.path.join(d, "pred.txt")
        LearnTask().run([conf, "task=pred", f"model_in={model}",
                         f"pred={want}"])
        with open(want) as f:
            want_lines = f.read().splitlines()
        ports = []
        for _ in range(2):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
            s.close()
        spec = ",".join(f"serve_dispatch_delay:delay=0.05@{i}"
                        for i in range(1, 2001))
        env = dict(os.environ, CXXNET_FAULT=spec,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = os.path.join(d, "serve.txt")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch.main", conf,
             "task=serve", f"model_in={model}", f"pred={out}",
             "serve_rows=0", f"serve_port={ports[0]}",
             f"metrics_port={ports[1]}", "metrics_host=127.0.0.1"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            lines = []
            for ln in proc.stdout:
                lines.append(ln)
                if "warmup done" in ln:
                    break
            base = f"http://127.0.0.1:{ports[1]}"
            if not wait_for(lambda: "cxxnet_serve_requests_total" in
                            urllib_get(base + "/metrics"), 60.0):
                raise AssertionError("/metrics never showed serve.requests")
            metrics = urllib_get(base + "/metrics")
            problems = validate_exposition(metrics)
            code, _h, body = post_json(ports[0], json.dumps(
                {"data": [[0.5] * 784]}).encode())
            proc.send_signal(signal.SIGTERM)
            rest, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        stdout = "".join(lines) + rest
        if proc.returncode != 0 or problems or code != 200:
            raise AssertionError(f"task=serve exited {proc.returncode}, "
                                 f"/metrics {problems[:2]}, /predict "
                                 f"{code}:\n{stdout}{err[-2000:]}")
        with open(out) as f:
            got = f.read().splitlines()
        m = re.search(r"serve: (\d+) requests \((\d+) rows\)", stdout)
        if ("SIGTERM - draining" not in stdout or not m
                or int(m.group(2)) != len(got) + 1
                or not 0 < len(got) < 2000 or got != want_lines[:len(got)]):
            raise AssertionError(f"drain: {len(got)} lines, summary "
                                 f"{m and m.group(0)}:\n{stdout}")
    say(f"scraped /metrics while serving ({len(metrics)} bytes, valid), "
        f"/predict {code}; SIGTERM after warmup: exit 0, {len(got)} of "
        f"2000 rows served, every one in the output and equal to task = "
        f"pred's line ({m.group(0)}, the /predict row included)")
    return dict(rows_before_sigterm=len(got))


def phase_front(torch, card):
    """Phase 12: the serving front on the card (see the module
    docstring); returns its figures."""
    import numpy as np
    from cxxnet_tpu_torch.nnet import checkpoint
    t12 = time.perf_counter()
    reqs = phase4_requests(np)
    tr = alexnet_trainer([])
    tr_new = alexnet_trainer(["seed=8"])
    out = {}
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "0002.model")
        with open(src, "wb") as fo:
            tr_new.save_model(fo)
        published = os.path.join(d, "serving.model")
        checkpoint.publish_model(src, published)
        out["in_process"] = front_in_process(torch, card, tr, reqs)
        srv, out["http"] = front_http(torch, card, tr, reqs)
        try:
            out["shed"] = front_shed_deadline(srv, reqs)
            out["swap"] = front_swap(srv, tr, tr_new, published, reqs)
            out["canary"] = front_canary(torch, srv, tr_new, d, reqs)
        finally:
            stats = srv.drain()
        if stats["errors"]:
            raise AssertionError(f"the front's dispatches failed: {stats}")
    out["int8"] = front_int8(torch, card, reqs)
    out["cli"] = front_cli(torch)
    say(f"phase 12 took {time.perf_counter() - t12:.1f} s")
    say("phase 12 summary " + json.dumps(out, default=float))
    return out


# ---------------------------------------------------------------------------
# phase 13: the reference's own surface - task = extract, reference-binary
# checkpoints, the numpy wrapper, the C ABI, extra inputs, keep_latest and
# test_io - in a fresh process (`chip_smoke.py --leg 13 OUT [DIR]`)
# ---------------------------------------------------------------------------

# AlexNet.conf's fc7 after its relu and dropout (node 20 = top[-2])
EXTRACT_NODE = "20"

# the extract task's pred block: phase 10's 512 training images, center
# crop and the mean image (no random augmentation)
ALEXNET_EXTRACT_BLOCK = """
pred = features.txt
iter = imgbin
  image_list = "./data/train.lst"
  image_bin = "./data/train.bin"
  image_root = "./data/resize256/"
  image_mean = "models/image_net_mean.bin"
iter = end
"""

# the extra-input net of tests/test_trainer.py:505-523 (no shipped conf
# declares extra_data_num): the label depends only on the extra input
EXTRA_NET = """
extra_data_num = 1
extra_data_shape[0] = 1,1,4
netconfig=start
layer[in,in_1->2] = concat
layer[2->3] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[3->4] = relu
layer[4->5] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[5->5] = softmax
netconfig=end
input_shape = 1,1,4
batch_size = 8
eta = 0.2
momentum = 0.9
metric = error
silent = 1
"""


def alexnet_netconfig() -> str:
    """AlexNet.conf with its iterator blocks cut off: the netconfig and
    the global keys, as the wrapper and the C ABI take a net's config."""
    with open(os.path.join(IMAGENET_CONFS, "AlexNet.conf")) as f:
        text = f.read()
    return text[text.index("netconfig=start"):] + "\nsilent = 1\n"


def legacy_file_bytes(tr) -> int:
    """The size of a reference-binary AlexNet checkpoint worked out from
    the net: int32 net_type, the 152-byte NetParam, each node name
    (uint64 length + bytes), each layer's record (type, primary index,
    name, input and output node lists), the int64 epoch, the blob's
    uint64 length, then per weighted layer the 328-byte LayerParam, its
    wmat (uint32 dims + float32 data: 3-D for conv, 2-D for fullc) and
    its bias (1-D, written also under no_bias)."""
    import numpy as np
    cfg = tr.net_cfg
    size = 4 + 152
    size += sum(8 + len(n.encode()) for n in cfg.node_names)
    size += sum(8 + 8 + len(info.name.encode()) + 8
                + 4 * len(info.nindex_in) + 8 + 4 * len(info.nindex_out)
                for info in cfg.layers)
    size += 8 + 8
    shapes = tr.net.param_shapes()
    for idx, info in enumerate(cfg.layers):
        if info.is_shared or info.type_name not in ("conv", "fullc"):
            continue
        w = shapes[info.name]["wmat"]
        size += 328 + 4 * (3 if info.type_name == "conv" else 2)
        size += 4 * int(np.prod(w)) + 4 + 4 * w[0]
    return size


def surface_legacy(torch, work: str):
    """13b: AlexNet.conf trained one round through the CLI with
    model_format = cxxnet; the file's size against the conf's byte
    count, the reloaded net's predict_dist rows bitwise, finetune.
    Returns (the round's model, its kernel launches)."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.main import LearnTask
    say("== phase 13b: model_format = cxxnet (reference-binary checkpoints) "
        "through the CLI, AlexNet.conf b256 bfloat16 ==")
    conf = os.path.join(IMAGENET_CONFS, "AlexNet.conf")
    kernels.reset_launches()
    task = LearnTask()
    t0 = time.perf_counter()
    task.run([conf, "model_format=cxxnet", "num_round=1", "max_round=1",
              "seed=7"])
    secs = time.perf_counter() - t0
    counts = kernels.launches()
    model = os.path.join(work, "models", "0001.model")
    with open(model, "rb") as f:
        head = f.read(8)
    if head[:5] == b"CXTPU":
        raise AssertionError("model_format = cxxnet wrote a native file")
    size, want = os.path.getsize(model), legacy_file_bytes(task.net_trainer)
    say(f"one round through the CLI in {secs:.1f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }; models/0001.model: "
        f"{size} bytes, {want} worked out from the conf (net_type "
        f"{struct.unpack('<i', head[:4])[0]})")
    if size != want:
        raise AssertionError(f"legacy file {size} bytes != {want}")
    rng = np.random.RandomState(21)
    batch = DataBatch(
        data=(rng.rand(256, 3, 227, 227) * 255 - 128).astype(np.float32),
        label=np.zeros((256, 1), np.float32))
    before = task.net_trainer.predict_dist(batch)
    tr = task.create_net()
    with open(model, "rb") as f:
        tr.load_model(f)
    after = tr.predict_dist(batch)
    if tr.epoch != task.net_trainer.epoch or not np.array_equal(before,
                                                                 after):
        raise AssertionError(
            f"reloaded legacy model: epoch {tr.epoch} vs "
            f"{task.net_trainer.epoch}, max abs "
            f"{np.abs(before - after).max():.3e}")
    say(f"loaded back on the card: predict_dist rows of 256 images "
        f"bitwise equal to the trainer's before the save (epoch "
        f"{tr.epoch})")
    del tr, task
    ft = LearnTask()
    ft.run([conf, "task=finetune", f"model_in={model}", "num_round=1",
            "max_round=1", "model_dir=finetuned", "seed=8"])
    tuned = sorted(os.listdir(os.path.join(work, "finetuned")))
    if tuned != ["0000.model"]:
        raise AssertionError(f"finetune from the legacy model wrote "
                             f"{tuned}")
    say(f"task = finetune from it: one more round, finetuned/ holds "
        f"{tuned}")
    del ft
    torch.cuda.empty_cache()
    return model, counts


def surface_extract(torch, card: str, work: str, model: str):
    """13a: task = extract through the CLI on the imgbin set: node 20 by
    name and as top[-2], text and raw rows, top[-1]; the .meta lines,
    the rows against NetTrainer.extract_feature in process (bitwise)
    and top[-1] against predict_dist (phase 4's bar). Returns the raw
    node-20 rows and the figures."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch import main as port_main
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.main import LearnTask
    say("== phase 13a: task = extract through the CLI, AlexNet.conf "
        "b256 bfloat16, 512 imgbin images ==")
    conf = os.path.join(work, "alexnet_extract.conf")
    with open(os.path.join(IMAGENET_CONFS, "AlexNet.conf")) as f, \
            open(conf, "w") as g:
        g.write(f.read() + ALEXNET_EXTRACT_BLOCK)
    base = ["task=extract", f"model_in={model}", "silent=1"]
    outs, launches = {}, {}
    for tag, node, fmt in (("name_txt", EXTRACT_NODE, "txt"),
                           ("name_raw", EXTRACT_NODE, "bin"),
                           ("top2_raw", "top[-2]", "bin"),
                           ("top1_raw", "top[-1]", "bin")):
        out = os.path.join(work, f"{tag}.out")
        kernels.reset_launches()
        if port_main.main([conf] + base + [f"extract_node_name={node}",
                                           f"output_format={fmt}",
                                           f"pred={out}"]) != 0:
            raise AssertionError(f"task=extract {tag} failed")
        launches[tag] = kernels.launches()
        with open(out, "rb") as f, open(out + ".meta") as fm:
            outs[tag] = (f.read(), fm.read())
    meta = {k: v[1].strip() for k, v in outs.items()}
    if outs["name_raw"] != outs["top2_raw"]:
        raise AssertionError("node 20 by name and top[-2] differ")
    if (meta["name_raw"] != "512,1,1,4096" or meta["name_txt"] != meta[
            "name_raw"] or meta["top1_raw"] != "512,1,1,1000"):
        raise AssertionError(f".meta lines {meta}")
    rows = np.frombuffer(outs["name_raw"][0], np.float32).reshape(512, 4096)
    text = "".join(" ".join(f"{v:g}" for v in r) + "\n" for r in rows)
    if outs["name_txt"][0].decode() != text:
        raise AssertionError("the text rows are not the raw rows' %g")
    for tag, c in launches.items():
        if c["lrn_fwd"] != 4 or c["lrn_bwd"] != 0:
            raise AssertionError(f"extract {tag} launched {c}, expected "
                                 "K1-fwd twice in each of 2 batches")
    say(f"node {EXTRACT_NODE} by name and top[-2]: the same {len(outs['name_raw'][0])} "
        f"raw bytes; text rows = the raw rows' %g; .meta {meta['name_raw']}"
        f" / top[-1] {meta['top1_raw']}; K1-fwd {launches['name_raw']['lrn_fwd']}"
        " launches in 2 batches of each run")
    # in process: the CLI's own trainer and pred iterator
    task = LearnTask()
    task.load_conf(conf, base + [f"extract_node_name={EXTRACT_NODE}",
                                 "output_format=bin",
                                 f"pred={os.path.join(work, 'timed.out')}"])
    task.init()
    feats, dists, datas = [], [], []
    it = task.itr_pred
    it.before_first()
    while it.next():
        b = it.value()
        datas.append(np.array(b.data))
        feats.append(task.net_trainer.extract_feature(b, EXTRACT_NODE))
        dists.append(task.net_trainer.predict_dist(b))
    feat = np.concatenate(feats).reshape(512, 4096)
    if not np.array_equal(feat, rows):
        raise AssertionError(f"CLI rows differ from extract_feature: max "
                             f"abs {np.abs(feat - rows).max():.3e}")
    top1 = np.frombuffer(outs["top1_raw"][0], np.float32).reshape(512, 1000)
    worst, worst_rel, undecided, flipped = check_bf16_rows(
        task.net_trainer, datas, [top1[:256], top1[256:]], dists)
    say(f"raw rows = NetTrainer.extract_feature in process, bitwise; "
        f"top[-1] against predict_dist: max abs {worst:.3e}, max rel "
        f"{worst_rel:.3e} (bar rtol {BF16_RTOL} atol {BF16_ATOL})")
    # rows/s: the CLI's task, raw output, warm (its model and iterator
    # ready)
    t0 = time.perf_counter()
    task.task_extract_feature()
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = 0
    it.before_first()
    while it.next():
        n += it.value().batch_size
    it_secs = time.perf_counter() - t0
    rps = 512 / secs
    say(f"task = extract, raw rows of node {EXTRACT_NODE}: {rps:.1f} rows/s "
        f"({secs:.3f} s for 512 rows, host clock); the pred iterator "
        f"alone {n / it_secs:.1f} rows/s; {card}")
    del task
    torch.cuda.empty_cache()
    return datas[0], rows, {"rows_s": rps, "iterator_rows_s": n / it_secs,
                            "launches": launches["name_raw"],
                            "max_abs_top1": worst}


def surface_wrapper_train(torch, card: str):
    """13c, first half: wrapper.train on numpy arrays at AlexNet's net,
    256 images (staged once) and 1,024 (prefetched), 2 rounds each; the
    first step equal in both; images/s of the second round; the idle
    share of one profiled round of the prefetched path."""
    import numpy as np
    import cxxnet_tpu_torch.wrapper as W
    from cxxnet_tpu_torch import kernels
    say("== phase 13c: wrapper.train on numpy arrays, AlexNet.conf's net "
        "(b256, bfloat16) ==")
    cfg = alexnet_netconfig()
    rng = np.random.RandomState(13)
    data = (rng.rand(1024, 3, 227, 227) * 255 - 128).astype(np.float32)
    label = rng.randint(0, 1000, size=1024).astype(np.float32)
    item = 3 * 227 * 227 * 4
    if not 256 * item < W._STAGE_BYTES_LIMIT < 1024 * item:
        raise AssertionError("the two runs must take the two paths")
    orig_update, orig_start = W.NetTrainer.update, W.Net.start_round
    orig_prefetch = W.NetTrainer.prefetch
    rec = {}

    def update(self, batch, keep=None):
        loss = orig_update(self, batch, keep)
        if "first" not in rec:
            rec["first"] = (float(loss),
                            self.state["params"]["fc8"]["wmat"].clone())
        return loss

    def start_round(self, r):
        torch.cuda.synchronize()
        rec.setdefault("starts", []).append(time.perf_counter())
        return orig_start(self, r)

    def prefetch(self, it, depth=1, chunk=1):
        rec["prefetched"] = True
        return orig_prefetch(self, it, depth, chunk)

    W.NetTrainer.update, W.Net.start_round = update, start_round
    W.NetTrainer.prefetch = prefetch
    runs = {}
    try:
        for n in (256, 1024):
            rec.clear()
            kernels.reset_launches()
            net = W.train(cfg, data[:n], label[:n], num_round=2,
                          param={"seed": 7}, batch_size=256, dev="gpu")
            torch.cuda.synchronize()
            end = time.perf_counter()
            counts = kernels.launches()
            steps = 2 * n // 256
            if (counts["lrn_fwd"] != 2 * steps
                    or counts["lrn_bwd"] != 2 * steps):
                raise AssertionError(f"wrapper.train({n}) launched "
                                     f"{counts} in {steps} steps")
            if rec.get("prefetched", False) != (n == 1024):
                raise AssertionError(f"wrapper.train({n}) took the wrong "
                                     "path")
            ips = n / (end - rec["starts"][1])
            runs[n] = {"first": rec["first"], "images_s": ips,
                       "counts": counts, "net": net}
            say(f"{n} images ({'prefetched' if n == 1024 else 'staged once'}"
                f"): 2 rounds, round 2 {ips:.1f} images/s (host clock); "
                f"K1-fwd {counts['lrn_fwd']} / K1-bwd {counts['lrn_bwd']} "
                f"launches in {steps} steps; {card}")
            if n == 256:
                del net
                runs[n]["net"] = None
    finally:
        W.NetTrainer.update, W.Net.start_round = orig_update, orig_start
        W.NetTrainer.prefetch = orig_prefetch
    (l0, w0), (l1, w1) = runs[256]["first"], runs[1024]["first"]
    if l0 != l1 or not torch.equal(w0, w1):
        raise AssertionError(f"the first step differs: loss {l0} vs {l1}")
    say(f"the first step (the first 256 images) is the same in both runs: "
        f"loss {l0:.6f}, fc8 after it bitwise equal")
    tr = runs[1024]["net"]._net

    def one_round():
        pf = tr.prefetch(W._Slices(data, label, 256), depth=1)
        try:
            pf.before_first()
            while pf.next():
                tr.update(pf.value())
        finally:
            pf.close()
    one_round()
    profiled = profile_steps(torch, one_round, 1, strict=True)
    say_profile(profiled, 1, card)
    busy, window = profiled[2], profiled[3]
    net = runs[1024]["net"]
    del data, runs[1024]["net"], tr
    return net, {"images_s_staged": runs[256]["images_s"],
                 "images_s_prefetched": runs[1024]["images_s"],
                 "idle": 1 - busy / window,
                 "launches": runs[1024]["counts"]}


def surface_wrapper_checks(torch, net, model: str, batch, rows):
    """13c, second half: Net.extract against 13a's CLI rows, bitwise;
    get_weight / set_weight of fc8 on the card, bitwise."""
    import numpy as np
    import cxxnet_tpu_torch.wrapper as W
    wnet = W.Net(dev="gpu", cfg=alexnet_netconfig())
    wnet.load_model(model)
    got = wnet.extract(batch, EXTRACT_NODE).reshape(256, 4096)
    if not np.array_equal(got, rows[:256]):
        raise AssertionError(f"Net.extract differs from the CLI's rows: "
                             f"max abs {np.abs(got - rows[:256]).max():.3e}")
    w = net.get_weight("fc8", "wmat")
    twice = w * 2
    net.set_weight(twice, "fc8", "wmat")
    back = net.get_weight("fc8", "wmat")
    net.set_weight(w, "fc8", "wmat")
    if (w.shape != (1000, 4096) or not np.array_equal(back, twice)
            or not np.array_equal(net.get_weight("fc8", "wmat"), w)):
        raise AssertionError("fc8 get/set_weight did not round-trip")
    say("Net.extract of node 20 = 13a's CLI rows, bitwise; fc8 "
        "get_weight / set_weight round trip bitwise on the card")
    del wnet
    torch.cuda.empty_cache()


def surface_capi(torch, card: str, work: str, steps: int = 4):
    """13d: the C ABI library and capi_driver.c built with g++, the
    driver run with device gpu on AlexNet.conf's netconfig: steps of
    CXNNetUpdateBatch at 256 x 3 x 227 x 227, then predict, extract,
    save, load and get/set weight through the ABI; its rows against
    wrapper.Net on the same weights and batch."""
    import numpy as np
    import cxxnet_tpu_torch.wrapper as W
    from cxxnet_tpu_torch import capi_build
    say("== phase 13d: the C ABI (libcxxnetwrapper + capi_driver.c), "
        "device gpu, AlexNet.conf's netconfig ==")
    say(f"C ABI embedding facts: {capi_build.embed_facts()}")
    t0 = time.perf_counter()
    lib = capi_build.build_library()
    exe = capi_build.build_driver()
    say(f"built {os.path.basename(lib)} and capi_driver with g++ in "
        f"{time.perf_counter() - t0:.2f} s")
    d = os.path.join(work, "capi")
    os.makedirs(d)
    netconf = os.path.join(d, "alexnet.conf")
    with open(netconf, "w") as f:
        f.write(alexnet_netconfig())
    log = os.path.join(d, "launches.json")
    model = os.path.join(d, "capi.model")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [exe, "gpu", netconf, "rand:256,3,227,227,1000", model, "fc8",
         str(steps), d],
        env=capi_build.driver_env(dict(os.environ, CXXNET_LAUNCH_LOG=log)),
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or "all checks passed" not in proc.stdout:
        raise AssertionError(f"capi_driver exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    with open(log) as f:
        counts = json.load(f)
    # each update: K1-fwd and K1-bwd twice; five forwards after them
    # (extract, predict, the too-small extract, two on the reloaded net)
    want = {"lrn_fwd": 2 * steps + 10, "lrn_bwd": 2 * steps}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the C ABI path launched {counts}, expected "
                             f"{want}")
    ips = float(re.search(r"c-abi images/s: ([0-9.]+)", proc.stdout)[1])
    say(f"capi_driver: exit 0 in {secs:.1f} s (the whole process); "
        f"{ips:.1f} images/s over CXNNetUpdateBatch (host clock, "
        f"{steps - 1} steps after the first); K1 launches {want}; {card}")
    batch = np.fromfile(os.path.join(d, "batch.f32"), np.float32).reshape(
        256, 3, 227, 227)
    rows = np.fromfile(os.path.join(d, "rows.f32"), np.float32).reshape(
        256, 1000)
    net = W.Net(dev="gpu", cfg=alexnet_netconfig())
    net.load_model(model)
    ref = net.extract(batch, "top[-1]").reshape(256, 1000)
    worst, worst_rel, _u, _f = check_bf16_rows(
        net._net, [batch], [rows], [ref])
    say(f"the driver's top[-1] rows against wrapper.Net on its saved "
        f"model and batch: max abs {worst:.3e} (phase 4's bar), bitwise "
        f"{np.array_equal(rows, ref)}")
    del net
    torch.cuda.empty_cache()
    return {"images_s": ips, "launches": counts, "secs": secs,
            "bitwise": bool(np.array_equal(rows, ref))}


def surface_extras(torch):
    """13e: the extra-input net trained on the card on numpy batches; the
    prefetcher's pinned ring carrying the extras (bitwise against
    streamed staging); Server.submit with extras against predict_dist;
    /predict with and without "extras"."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Server
    say("== phase 13e: extra inputs (extra_data_num = 1) on the card ==")
    rng = np.random.RandomState(6)

    def batch(n):
        x = rng.randn(n, 1, 1, 4).astype(np.float32)
        e = rng.randn(n, 1, 1, 4).astype(np.float32)
        y = (e.reshape(n, 4).sum(1) > 0).astype(np.float32).reshape(n, 1)
        return DataBatch(data=x, label=y, extra_data=[e])
    tr = NetTrainer(cfg=EXTRA_NET)
    tr.init_model()
    train = [batch(8) for _ in range(40)]
    for b in train:
        tr.update(b)
    test = batch(8)
    acc = float((tr.predict(test) == test.label.reshape(-1)).mean())
    if acc < 0.75:
        raise AssertionError(f"extra-input net: accuracy {acc}")
    pf = tr.prefetch(ListIter(train[:3]), 1)
    staged = []
    try:
        pf.before_first()
        while pf.next():
            staged.append(pf.value())
        for b, s in zip(train[:3], staged):
            want = tr.stage_batch(b)
            tr._await(s)
            if not (stage_equal(torch, s, want) and len(s.extras) == 1
                    and torch.equal(s.extras[0], want.extras[0])):
                raise AssertionError("the pinned ring's extras differ")
    finally:
        pf.close()
    say(f"40 steps on numpy batches with extras: accuracy {acc:.3f} on a "
        "fresh batch; the prefetcher's pinned ring carries data, labels "
        "and extras bitwise as streamed staging")
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=2, http_port=0,
                 metrics_host="127.0.0.1")
    srv.warmup()
    sizes = (1, 3, 8, 5, 11)
    reqs = [batch(n) for n in sizes]
    with srv:
        futs = [srv.submit(b.data, b.extra_data) for b in reqs]
        served = [f.result(timeout=60) for f in futs]
        port = srv.metrics_server.port
        one = reqs[1]
        body = json.dumps({"data": one.data.tolist(),
                           "extras": [one.extra_data[0].tolist()],
                           "raw": True}).encode()
        code, _, got = post_json(port, body)
        bad, _, err = post_json(port, json.dumps(
            {"data": one.data.tolist()}).encode())
    for b, rows in zip(reqs, served):
        ref = np.concatenate([tr.predict_dist(DataBatch(
            data=b.data[i:i + 8], label=b.label[i:i + 8],
            extra_data=[b.extra_data[0][i:i + 8]]))
            for i in range(0, b.data.shape[0], 8)])
        if not np.allclose(rows, ref, rtol=1e-4, atol=1e-6):
            raise AssertionError("served rows with extras differ from "
                                 "predict_dist")
    if code != 200 or not np.allclose(np.asarray(got["outputs"]),
                                      served[1], rtol=1e-6, atol=1e-7):
        raise AssertionError(f"/predict with extras: {code} {got}")
    if bad != 400 or "extra inputs" not in err.get("error", ""):
        raise AssertionError(f"/predict without extras: {bad} {err}")
    say(f"Server.submit with extras: {len(sizes)} requests of {sizes} rows "
        f"= predict_dist rows (rtol 1e-4, atol 1e-6); /predict with "
        f"\"extras\" 200 with the same rows, without 400 "
        f"({err['error']!r})")
    return {"accuracy": acc}


def surface_cli_tails():
    """13f: keep_latest = 2 and continue = 1, and test_io = 1, through the
    CLI on examples/MNIST/MNIST.conf unedited."""
    say("== phase 13f: keep_latest = 2 and test_io = 1 through the CLI, "
        "examples/MNIST/MNIST.conf ==")
    conf = os.path.join(REPO, "examples", "MNIST", "MNIST.conf")
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "data"))
        write_mnist(os.path.join(d, "data"), 2000, 3, "train")
        write_mnist(os.path.join(d, "data"), 500, 4, "t10k")
        run_cli([conf, "keep_latest=2", "num_round=4"], cwd=d)
        kept = sorted(os.listdir(os.path.join(d, "models")))
        if kept != ["0003.model", "0004.model"]:
            raise AssertionError(f"keep_latest = 2 kept {kept}")
        proc = run_cli([conf, "keep_latest=2", "continue=1", "num_round=5"],
                       cwd=d)
        kept2 = sorted(os.listdir(os.path.join(d, "models")))
        if ("Continue training from round 5" not in proc.stdout
                or kept2 != ["0004.model", "0005.model"]):
            raise AssertionError(f"continue = 1: {kept2}\n{proc.stdout}")
        say(f"keep_latest = 2, 4 rounds: models/ holds {kept}; continue = 1 "
            f"resumed from round 5: {kept2}")
        proc = run_cli([conf, "test_io=1", "num_round=1", "silent=0",
                        "model_dir=io_models"], cwd=d)
        counts = cli_launches(proc.stdout)
        if ("start I/O test" not in proc.stdout or any(counts.values())
                or not counts or "train-error" in proc.stderr):
            raise AssertionError(f"test_io = 1:\n{proc.stdout[-2000:]}"
                                 f"{proc.stderr[-2000:]}")
        say(f"test_io = 1: 'start I/O test', no metric line, kernel "
            f"launches {counts}")
    return {"kept": kept, "resumed": kept2}


def phase_surface(torch, card, d=None, tails="1"):
    """Phase 13 (see the module docstring); `d` is phase 10's directory
    (its shared imgbin set), or None to make a set here; `tails` "0"
    leaves (f) to the caller (the main flow runs it beside phase 10's
    CLI runs). Returns its figures."""
    t13 = time.perf_counter()
    out = {}
    net, out["wrapper"] = surface_wrapper_train(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        if d is None:
            fmt, _pil = image_format_used()
            d = tmp
            shared = os.path.join(d, "shared")
            write_image_set(shared, "data/resize256", "data/train", 512, 256,
                            10, 11, fmt)
            write_image_set(shared, "data/resize256_test", "data/test", 256,
                            256, 10, 12, fmt)
        work = os.path.join(tmp, "surface")
        os.makedirs(work)
        os.symlink(os.path.join(d, "shared", "data"),
                   os.path.join(work, "data"))
        cwd = os.getcwd()
        os.chdir(work)
        try:
            model, out["legacy_launches"] = surface_legacy(torch, work)
            batch, rows, out["extract"] = surface_extract(torch, card, work,
                                                          model)
            surface_wrapper_checks(torch, net, model, batch, rows)
            del net
            torch.cuda.empty_cache()
            out["capi"] = surface_capi(torch, card, work)
        finally:
            os.chdir(cwd)
    out["extras"] = surface_extras(torch)
    if tails == "1":
        out["cli"] = surface_cli_tails()
    say(f"phase 13 took {time.perf_counter() - t13:.1f} s")
    say("phase 13 summary " + json.dumps(out, default=float))
    return out


# ---------------------------------------------------------------------------
# phase 14: the native image decoder (use_native) on nvJPEG - a fresh-process
# leg
# ---------------------------------------------------------------------------

def read_records(reader):
    """Every record of one pass of a reader (NativeBinReader or
    PlainBinReader), which is closed after it."""
    out = []
    try:
        reader.before_first()
        while True:
            rec = reader.next()
            if rec is None:
                return out
            out.append(rec)
    finally:
        reader.close()


def say_distribution(label, got, want):
    """The |nvJPEG - PIL| distribution of a set, per level and channel."""
    import numpy as np
    d = np.abs(np.stack(got).astype(np.int16) - np.stack(want).astype(
        np.int16))
    hist = np.bincount(np.minimum(d, 17).ravel(), minlength=18)
    share = ", ".join(f"{k}: {hist[k] / d.size:.5f}" for k in range(17))
    say(f"{label}: |d| shares by level {{{share}, >16: "
        f"{hist[17] / d.size:.5f}}}; mean by channel (R, G, B) "
        f"{[round(float(v), 4) for v in d.mean(axis=(0, 2, 3))]}")


def native_facts(card):
    """14a: the decoder built (or cached by phase 2), its backend,
    nvJPEG's version and path and the hardware decoder's facts."""
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io import native
    say("== phase 14a: the nvJPEG decoder (csrc/nvjpeg_io.cu): build, "
        "facts and its kernel YccToRgb ==")
    secs, log = kernels.build_all(["nvjpeg_decode"])["nvjpeg_decode"]
    flags = kernels.source_flags("nvjpeg_decode")[len(kernels.NVCC_FLAGS):]
    say(f"nvjpeg_decode: {'cached' if log == 'cached' else f'{secs:.2f} s'}"
        f", {os.path.basename(kernels._lib_path('nvjpeg_decode'))}; its "
        f"own flags {' '.join(flags)}")
    facts = native.decoder_facts()
    hw = (f"{facts['hw_engines']} engines x {facts['hw_cores_per_engine']} "
          f"cores" if facts["hw_decoder_status"] == 0 else
          f"none reported (status {facts['hw_decoder_status']})")
    say(f"backend: {facts['backend']}")
    say(f"nvJPEG {facts['nvjpeg_version']} from {facts['libnvjpeg']}; the "
        f"card's hardware JPEG decoder as nvJPEG reports it: {hw} (the "
        f"decoder does not use it); on {card}")
    return facts


def native_kernel(torch, card):
    """14a: YccToRgb, the library's kernel, against its plain version,
    bitwise, at the main path's planes (256 x 256, 4:2:0 and 4:4:4), with
    its time (CUDA events, warm), the plain version's on the card and the
    bound. Returns the 4:2:0 row."""
    from cxxnet_tpu_torch.io.native import (FACTORS, ycc_to_rgb,
                                            ycc_to_rgb_plain)
    gen = torch.Generator().manual_seed(14)
    rows = {}
    for label in ("4:2:0", "4:4:4"):
        hf, vf = FACTORS[label]
        shapes = ((256, 256), (256 // vf, 256 // hf), (256 // vf, 256 // hf))
        planes = [torch.randint(0, 256, s, generator=gen, dtype=torch.uint8)
                  for s in shapes]
        dev = [p.cuda() for p in planes]
        got = ycc_to_rgb(*dev, hf, vf)
        torch.cuda.synchronize()
        err = int((got.cpu().int() - ycc_to_rgb_plain(*planes, hf, vf).int())
                  .abs().max())
        ms = time_warm(torch, lambda: ycc_to_rgb(*dev, hf, vf), 200)
        plain_ms = time_warm(torch, lambda: ycc_to_rgb_plain(*dev, hf, vf),
                             50)
        moved = sum(p.numel() for p in planes) + 3 * 256 * 256
        bound = moved / HBM_BYTES_PER_S * 1e3
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by="bytes")
        say(f"YccToRgb {label} (256 x 256): max |kernel - plain| {err}; "
            f"{ms_txt(ms)} a launch (warm), plain version "
            f"{ms_txt(plain_ms)}, bound {ms_txt(bound)} ({moved:,} bytes); "
            f"on {card}")
        if err != 0:
            raise AssertionError(f"YccToRgb {label} != its plain version")
    return rows["4:2:0"]


def native_vs_pil(d, card):
    """14b: per record against PIL's decode of the same blob, at
    io/native.py's PIL_BAR: 256 x 256, quality 90, a set of 512 images
    for each subsampling PIL writes (4:4:4, 4:2:2, 4:2:0) and of 128 for
    the other kinds the decoder takes (4:4:0, 4:1:1, grayscale, R, G, B).
    Every record must be decoded on the card. Returns {kind: stats}."""
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.native import (JPEG_KINDS, PIL_BAR,
                                            NativeBinReader, PlainBinReader,
                                            pil_agreement, within_bar)
    say("== phase 14b: nvJPEG against PIL's decode of the same blobs "
        "(256 x 256, quality 90; 512 images a set, 128 for the kinds PIL "
        "does not write by default) ==")
    out = {}
    for label in JPEG_KINDS:
        count = 512 if label in ("4:4:4", "4:2:2", "4:2:0") else 128
        sd = os.path.join(d, "s" + label.replace(":", ""))
        write_image_set(sd, "data/resize256", "data/train", count, 256, 10,
                        51, "JPEG", kind=label)
        binp = os.path.join(sd, "data", "train.bin")
        kernels.reset_launches()
        got = read_records(NativeBinReader([binp], out_mode=2))
        n, raw = kernels.launches()["nvjpeg_decode"], kernels.raw_handbacks()
        want = read_records(PlainBinReader([binp], out_mode=2))
        st = pil_agreement(got, want)
        held = within_bar(st)
        say(f"{label}: {len(got)} records, {n} decoded by nvJPEG, {raw} "
            f"handed back; |nvJPEG - PIL| max {st['max']:.0f}, mean "
            f"{st['mean']:.4f}, share over 16 {st['over16']:.5f}; bar "
            f"{PIL_BAR}: {'held' if held else 'MISSED'}")
        say_distribution(label, got, want)
        if n != count or raw != 0 or not held:
            raise AssertionError(f"{label}: the decoder against PIL: {st}, "
                                 f"{n} decoded, {raw} handed back")
        out[label] = st
    return out


def native_stream_checks(d):
    """14b: the stream, exactly: order and counters, before_first three
    times, two bins, a missing file, PNG / PPM / a truncated JPEG handed
    back raw, out_mode 1 against 2."""
    import io
    import numpy as np
    from PIL import Image
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.native import (NativeBinReader, PlainBinReader,
                                            pil_agreement, within_bar)
    from cxxnet_tpu_torch.utils.binary_page import BinaryPageWriter
    say("== phase 14b: the decoder's stream checks ==")
    rng = np.random.RandomState(61)

    def jpeg(h, w):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(
            np.uint8)).save(buf, format="JPEG", quality=90, subsampling=0)
        return buf.getvalue()

    def pack(path, blobs):
        with open(path, "wb") as f:
            w = BinaryPageWriter(f)
            for b in blobs:
                w.push(b)
            w.close()
        return path
    # order: 40 images of 40 distinct sizes, on 4 workers
    blobs = [jpeg(16 + i, 48 - i) for i in range(40)]
    b1 = pack(os.path.join(d, "order.bin"), blobs)
    kernels.reset_launches()
    r = NativeBinReader([b1], n_threads=4, max_inflight=6, out_mode=2)
    passes = []
    for _ in range(3):
        passes.append([])
        r.before_first()
        while True:
            rec = r.next()
            if rec is None:
                break
            passes[-1].append(rec)
    counts = (kernels.launches()["nvjpeg_decode"], kernels.raw_handbacks())
    r.close()
    want = read_records(PlainBinReader([b1], out_mode=2))
    for recs in passes:
        if [x.shape for x in recs] != [x.shape for x in want]:
            raise AssertionError("nvJPEG records out of stream order")
        for g, w in zip(recs, want):
            if not within_bar(pil_agreement([g], [w])):
                raise AssertionError("a record off PIL's bar")
    if counts != (120, 0):
        raise AssertionError(f"3 passes of 40: (decoded, raw) {counts}")
    say(f"stream order: 40 images of 40 sizes in order on 4 workers "
        f"(max_inflight 6), 3 passes (before_first each); the library "
        f"counted (decoded, raw) {counts}")
    # two bins
    b2 = pack(os.path.join(d, "second.bin"), blobs[:7])
    recs = read_records(NativeBinReader([b1, b2], out_mode=2))
    if [x.shape for x in recs] != [x.shape for x in want + want[:7]]:
        raise AssertionError("two bins: records out of order")
    # out_mode 1 against 2
    f32 = read_records(NativeBinReader([b1], out_mode=1))
    if any(a.dtype != np.float32 or not np.array_equal(a, b)
           for a, b in zip(f32, passes[0])):
        raise AssertionError("out_mode 1 != out_mode 2 as float32")
    say("two bins: 47 records in order; out_mode 1 (float32) equals "
        "out_mode 2 (uint8) record for record")
    # a missing file
    r = NativeBinReader([os.path.join(d, "nope.bin")])
    r.before_first()
    try:
        r.next()
        raise AssertionError("a missing .bin did not raise")
    except IOError as e:
        say(f"missing file: IOError({e})")
    finally:
        r.close()
    # PNG, PPM and a JPEG cut in its headers come back raw
    arr = rng.randint(0, 255, (24, 24, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    raw_bin = pack(os.path.join(d, "raw.bin"), [
        buf.getvalue(), b"P6\n24 24\n255\n" + arr.tobytes(), blobs[0],
        blobs[1][:300]])
    kernels.reset_launches()
    r = NativeBinReader([raw_bin], out_mode=2)
    r.before_first()
    got = [r.next() for _ in range(3)]
    if not (np.array_equal(got[0], arr.transpose(2, 0, 1))
            and np.array_equal(got[1], arr.transpose(2, 0, 1))):
        raise AssertionError("PNG / PPM handed back != PIL's decode")
    try:
        r.next()
        raise AssertionError("the truncated JPEG decoded")
    except OSError as e:
        truncated = f"{type(e).__name__}({e})"
    if r.next() is not None:
        raise AssertionError("a record after the truncated JPEG")
    r.close()
    # the library counts in its workers, which decode ahead of next():
    # the counts are read once the stream has ended
    counts = (kernels.launches()["nvjpeg_decode"], kernels.raw_handbacks())
    if counts != (1, 3):
        raise AssertionError(f"PNG + PPM + JPEG + a truncated JPEG: "
                             f"(decoded, raw) {counts}")
    say(f"PNG and PPM handed back raw and decoded on the host bitwise, "
        f"the JPEG decoded, a JPEG cut at 300 bytes handed back raw and "
        f"PIL's error surfaced ({truncated}): (decoded, raw) = {counts}")


def native_iterator(d):
    """14c: AlexNet.conf's train block under use_native = 1 and shuffle
    = 1 on the card against its plain version (device cpu, the same
    order and reservoir) on (b)'s sets: labels and instance order
    bitwise, batches at the set's bar."""
    import numpy as np
    from cxxnet_tpu_torch.io.native import pil_agreement, within_bar
    say("== phase 14c: AlexNet.conf's train block, use_native = 1, "
        "shuffle = 1: the card against PlainBinReader ==")
    block = alexnet_train_block()
    out = {}
    for label in ("4:4:4", "4:2:0"):
        sd = os.path.join(d, "s" + label.replace(":", ""))
        os.makedirs(os.path.join(sd, "models"), exist_ok=True)
        # the mean image first (the PIL path, unshuffled): an iterator that
        # creates it draws from its shuffle reservoir on the way
        stop_iter(make_iter(block, sd))
        extra = [("use_native", "1"), ("shuffle", "1")]
        runs = []
        for dev in ("cuda:0", "cpu"):
            it = make_iter(block, sd, extra, dev)
            runs.append(pull(it, 2))
            stop_iter(it)
        (card_b, plain_b) = runs
        for a, b in zip(card_b, plain_b):
            if not np.array_equal(a.label, b.label):
                raise AssertionError(f"{label}: shuffled labels differ")
        st = pil_agreement([b.data for b in card_b],
                           [b.data for b in plain_b])
        held = within_bar(st)
        order = [int(v) for v in card_b[0].label[:12, 0]]
        say(f"{label}: 2 batches of {card_b[0].data.shape} "
            f"{card_b[0].data.dtype}, labels bitwise equal (first 12 "
            f"{order}); |card - plain| max {st['max']:.4f}, mean "
            f"{st['mean']:.4f}, share over 16 {st['over16']:.5f}: "
            f"{'held' if held else 'MISSED'}")
        if not held:
            raise AssertionError(f"{label}: batches off the bar: {st}")
        out[label] = st
    return out


def native_rates(tdir, card):
    """14d: decoded images/s of the readers alone over 10g's 3,072-image
    set: nvJPEG at 1, 4 and 8 threads, PlainBinReader (PIL) at 1 and 4
    over its first 1,024. Also the bytes of a b256 batch, for the
    bound."""
    from cxxnet_tpu_torch.io.native import NativeBinReader, PlainBinReader
    say("== phase 14d: decode rate alone, 10g's set (3,072 images, 256 x "
        "256 quality 90 4:2:0) ==")
    binp = os.path.join(tdir, "data", "train.bin")
    rates = {}
    for name, make, threads, most in (
            ("nvjpeg", NativeBinReader, (1, 4, 8), 3072),
            ("plain", PlainBinReader, (1, 4), 1024)):
        for th in threads:
            r = make([binp], n_threads=th, out_mode=2)
            r.before_first()
            n, t0 = 0, time.perf_counter()
            while n < most and r.next() is not None:
                n += 1
            rates[f"{name}_{th}"] = n / (time.perf_counter() - t0)
            r.close()
    say(f"[decode alone, images/s, host clock, CHW uint8 out] nvJPEG "
        f"{rates['nvjpeg_1']:.1f} / {rates['nvjpeg_4']:.1f} / "
        f"{rates['nvjpeg_8']:.1f} at 1 / 4 / 8 threads; PIL "
        f"(PlainBinReader) {rates['plain_1']:.1f} / {rates['plain_4']:.1f} "
        f"at 1 / 4; os.cpu_count() {os.cpu_count()}; on {card}")
    from cxxnet_tpu_torch.utils.binary_page import read_bin_blobs
    blob_bytes = 0
    for k, blob in enumerate(read_bin_blobs([binp])):
        if k == 256:
            break
        blob_bytes += len(blob)
    rates["batch_blob_bytes"] = blob_bytes
    return rates


def native_bound_ms(blob_bytes: int, n: int = 256, size: int = 256):
    """The least time the card could take to decode n size x size 4:2:0
    JPEGs into CHW uint8: the blobs read once and the pixels written once
    over the memory rate, against the IDCTs (2,048 flops an 8 x 8 block:
    16 eight-point transforms of 64 multiply-adds; 1,536 blocks an image:
    1,024 luma + 2 x 256 chroma) and the colour conversion (8 flops a
    pixel) over the float32 rate. Returns (ms, "bytes" | "operations")."""
    blocks = (size // 8) ** 2 + 2 * (size // 16) ** 2
    flops = n * (blocks * 2048 + size * size * 8)
    moved = blob_bytes + n * 3 * size * size
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def native_settings(torch, tdir, card):
    """14e: 10g's three settings with use_native = 1 on the card (nvJPEG),
    beside the step alone; then the host stages and which sets the pace
    inside the iterator."""
    say("== phase 14e: AlexNet b256 bfloat16 from imgbin with use_native "
        "= 1 (nvJPEG on the card): 10g's three settings ==")
    block = alexnet_train_block()
    tr = alexnet_trainer([])
    itr = make_iter(block, tdir, [("use_native", "1")], "cuda:0")
    staged = tr.stage_batch(pull(itr, 1)[0])
    stop_iter(itr)
    for _ in range(2):
        tr.update(staged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        tr.update(staged)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) * 100.0
    del staged
    say(f"the step alone: {device_ms:.3f} ms, {256 / device_ms * 1e3:.1f} "
        f"images/s; on {card}")
    results = {"step alone": dict(step_ms=device_ms,
                                  images_s=256 / device_ms * 1e3)}
    tr = timed_settings(torch, tr, block, tdir, device_ms, card, results,
                        [("use_native", "1")], "cuda:0", "use_native = 1, ")
    del tr
    torch.cuda.empty_cache()
    results["host stages"] = host_stage_rates(tdir, card)
    return results


def native_cli(counts):
    """14f: AlexNet.conf unedited through the CLI under its default
    use_native = -1 - phase 10c's run (2 rounds with eval lines, K1,
    continue = 1, task = pred), which on the card decodes with nvJPEG: its
    kernel launches line must show the decoder's launches and no raw
    hand-back."""
    say("== phase 14f: AlexNet.conf through the CLI, use_native = -1 (the "
        "conf's default): phase 10c's run ==")
    if (counts.get("nvjpeg_decode", 0) <= 0
            or counts.get("raw_handbacks") != 0
            or counts.get("lrn_fwd", 0) <= 0):
        raise AssertionError(f"AlexNet.conf's CLI run did not decode with "
                             f"nvJPEG alone: {counts}")
    say(f"task = train, 2 rounds: {counts['nvjpeg_decode']} images decoded "
        f"by nvJPEG, {counts['raw_handbacks']} raw hand-backs, K1-fwd "
        f"{counts['lrn_fwd']}, K1-bwd {counts['lrn_bwd']} launches")


def native_entry(nat, cli_counts):
    """The kernels line's row of the decoder: YccToRgb (its kernel)
    against its plain version, and the decode's own figures."""
    k, rates = nat["kernel"], nat["rates"]
    return {
        "name": "nvjpeg_decode",
        "route": "cuda",
        "source": "cxxnet_tpu_torch/csrc/nvjpeg_io.cu",
        "replaces": "native/cxxnet_io.cc:77",
        "replaces_fn": "DecodeJpeg (libjpeg on the host, the JAX package's "
                       "use_native decoder; not a Pallas kernel)",
        "unit": "YccToRgb, one launch an image decoded: 256 x 256 4:2:0 "
                "Y, Cb, Cr planes -> CHW uint8 RGB, L2 warm (phase 14a)",
        "launches": cli_counts["nvjpeg_decode"],
        "launches_unit": "AlexNet.conf task = train through the CLI, 2 "
                         "rounds with eval, use_native = -1 (phase 10c)",
        "raw_handbacks": cli_counts["raw_handbacks"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
        "decode_unit": "one b256 batch of 10g's 256 x 256 quality-90 4:2:0 "
                       "JPEGs decoded on 4 workers into CHW uint8, host "
                       "clock (phase 14d)",
        "decode_ms": 256 / rates["nvjpeg_4"] * 1e3,
        "decode_plain_ms": 256 / rates["plain_4"] * 1e3,
        "decode_bound_ms": nat["bound_ms"],
        "decode_bound_by": nat["bound_by"],
        "decode_images_s": {th: rates[f"nvjpeg_{th}"] for th in (1, 4, 8)},
        "plain_images_s": {th: rates[f"plain_{th}"] for th in (1, 4)},
        "vs_pil": nat["vs_pil"],
    }


def native_checks(torch, card):
    """14b-c, which check and time nothing: nvJPEG against PIL, the
    stream checks and the iterator on the card against PlainBinReader,
    on sets of their own. A leg of its own (`chip_smoke.py --leg 14u
    OUT`), which the main flow runs beside phase 10's CLI runs."""
    with tempfile.TemporaryDirectory() as work:
        out = {"vs_pil": native_vs_pil(work, card)}
        native_stream_checks(work)
        out["iterator"] = native_iterator(work)
    return out


def phase_native(torch, card, d=None, fmt="JPEG", checks="1"):
    """Phase 14 (see the module docstring): `d` is phase 10's directory
    (its timing set from 10g and the mean image), or None to make the
    timing set here; `checks` "0" leaves (b)-(c) to the caller
    (`native_checks`). Returns its figures."""
    t14 = time.perf_counter()
    if fmt != "JPEG":
        raise AssertionError("phase 14 needs PIL to write its JPEG sets")
    out = {"facts": native_facts(card), "kernel": native_kernel(torch, card)}
    with tempfile.TemporaryDirectory() as tmp:
        if d is None:
            d = tmp
            tdir = os.path.join(d, "timing")
            write_image_set(tdir, "data/resize256", "data/train", 3072, 256,
                            10, 41, "JPEG")
            os.makedirs(os.path.join(tdir, "models"))
            make_iter(alexnet_train_block(), tdir)  # writes the mean image
        tdir = os.path.join(d, "timing")
        if checks == "1":
            out.update(native_checks(torch, card))
        out["rates"] = native_rates(tdir, card)
        out["bound_ms"], out["bound_by"] = native_bound_ms(
            out["rates"]["batch_blob_bytes"])
        out["settings"] = native_settings(torch, tdir, card)
    say(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    say("phase 14 summary " + json.dumps(out, default=float))
    return out


# ---------------------------------------------------------------------------
# phase 15: the trainer's last single-device keys - steps_per_dispatch
# (fused chunks), remat, profile / profile_dir / trace_round, tuning_cache
# - in a fresh process (`chip_smoke.py --leg 15 OUT [DIR]`)
# ---------------------------------------------------------------------------

MNIST_CONV_CONF = os.path.join(REPO, "examples", "MNIST", "MNIST_CONV.conf")


def _state_bits(torch, tr):
    """Every param and updater-state tensor of `tr`, as host arrays."""
    out = []
    for tree in (tr.state["params"], tr.state["ustate"]):
        stack = [tree]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t[k] for k in sorted(t, reverse=True))
            else:
                out.append(t.detach().float().cpu().numpy())
    return out


def _bits_equal(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x.view(np.uint32),
                                              y.view(np.uint32))
        for x, y in zip(a, b))


def dispatch_alexnet(torch, card):
    """(a) AlexNet.conf b256 bfloat16 on 8 cached batches, update_period
    = 2 and check_nan = 1, batch 5 poisoned with NaN: steps_per_dispatch
    = 4 (two chunks) against 8 update() calls. Params and updater state
    bitwise, the NaN microstep dropped in both, the same K1 launches, one
    guard readback a chunk; then the step time a microstep in turns
    (K = 1, 4, 4, 1, four good microsteps each) and the idle share of
    each."""
    import warnings

    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    say("== phase 15a: AlexNet.conf b256 bfloat16, steps_per_dispatch = 4 "
        "against 1 (update_period = 2, check_nan = 1, one NaN batch) ==")
    rng = np.random.RandomState(15)
    host = [DataBatch(data=(rng.rand(256, 3, 227, 227) * 255).astype(
        np.float32), label=rng.randint(0, 1000, (256, 1)).astype(
        np.float32)) for _ in range(4)]
    # 8 microsteps over 4 distinct batches; the 6th is poisoned
    host = host + [host[0], DataBatch(
        data=np.full_like(host[1].data, np.nan), label=host[1].label),
        host[2], host[3]]
    keys = ["update_period=2", "check_nan=1"]
    out, runs, trainers = {}, {}, {}
    for k in (1, 4):
        tr = alexnet_trainer(keys + [f"steps_per_dispatch={k}"])
        staged = [tr.stage_batch(b) for b in host]
        items = (staged if k == 1 else
                 [tr.stage_chunk(staged[i:i + k]) for i in range(0, 8, k)])
        del staged
        torch.cuda.synchronize()
        kernels.reset_launches()
        for it in items:
            tr.update(it)
        torch.cuda.synchronize()
        counts = kernels.launches()
        runs[k] = _state_bits(torch, tr)
        out[f"k{k}"] = {"launches": counts,
                        "guard_readbacks": tr.guard_readbacks,
                        "bad_rounds": tr.bad_rounds, "epoch": tr.epoch,
                        "step_ms": []}
        # the good items of a turn: 4 updates, or the first chunk
        trainers[k] = (tr, items[:4] if k == 1 else items[:1])
    if not _bits_equal(runs[1], runs[4]):
        raise AssertionError("steps_per_dispatch = 4 differs from 1 after 8 "
                             "updates")
    a, b = out["k1"], out["k4"]
    if (a["bad_rounds"], b["bad_rounds"]) != (1, 1) or a["epoch"] != 3 \
            or b["epoch"] != 3:
        raise AssertionError(f"the NaN microstep: {a} {b}")
    if a["launches"] != b["launches"] or a["launches"]["lrn_fwd"] != 16 \
            or a["launches"]["lrn_bwd"] != 16:
        raise AssertionError(f"K1 launches {a['launches']} vs "
                             f"{b['launches']}")
    if (a["guard_readbacks"], b["guard_readbacks"]) != (8, 2):
        raise AssertionError("guard readbacks: one per update or chunk")
    say("params and updater state bitwise equal after 8 updates; the NaN "
        "microstep dropped in both; K1 launched 16 + 16 times in each; "
        "guard readbacks 8 (K = 1) and 2 (K = 4)")
    # timed after the bitwise runs, so neither pays the first launches
    for k in (1, 4, 4, 1):
        tr, good = trainers[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in good:
            tr.update(it)
        torch.cuda.synchronize()
        out[f"k{k}"]["step_ms"].append((time.perf_counter() - t0) * 1e3 / 4)
    for k in (1, 4):
        tr, good = trainers[k]
        it = iter(good)
        rows, groups, busy, window = profile_steps(
            torch, lambda: tr.update(next(it)), len(good), strict=True)
        out[f"k{k}"]["idle"] = 1 - busy / window
        out[f"k{k}"]["profiled_ms_per_microstep"] = window / 4
    # synchronising calls in one chunk (torch's sync debug mode): the
    # guard's readback is the one the design has
    tr, good = trainers[4]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.update(good[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    syncs = [str(x.message).splitlines()[0] for x in w
             if "called a synchronizing" in str(x.message)]
    b["syncs_in_one_chunk"] = len(syncs)
    for k in (1, 4):
        r = out[f"k{k}"]
        say(f"K = {k}: " + " / ".join(f"{v:.3f}" for v in r["step_ms"])
            + f" ms a microstep (host clock, 4 good microsteps a turn, turns "
            f"K = 1, 4, 4, 1, the guard's readbacks included), idle share "
            f"{r['idle']:.4f} ({r['profiled_ms_per_microstep']:.3f} ms a "
            f"microstep in the traced window) on {card}")
    say(f"synchronising calls in one chunk of 4: {len(syncs)} (the guard's "
        "finite-vector readback)")
    del trainers, tr, good
    return out


def dispatch_seq_cli(torch, card):
    """(b) seq_mnist.conf through the CLI at K = 4 against K = 1
    (tools/fused_smoke.py): byte-equal checkpoints and eval lines,
    train.chunk spans, K2 launched alike."""
    from cxxnet_tpu_torch.tools import fused_smoke
    say("== phase 15b: seq_mnist.conf through the CLI, steps_per_dispatch "
        "= 4 against 1 (tools/fused_smoke.py) ==")
    with tempfile.TemporaryDirectory() as d:
        res = fused_smoke.run_smoke(d, conf=SEQ_CONF, train_n=600,
                                    extra=["num_round=2", "max_round=2"])
    if not res["ok"]:
        raise AssertionError(f"fused_smoke on seq_mnist.conf: {res['checks']}")
    l1, l4 = res["k1"]["launches"], res["k4"]["launches"]
    if l1 != l4 or any(l1.get(n, 0) <= 0 for n in K2):
        raise AssertionError(f"K2 launches K=1 {l1}, K=4 {l4}")
    say(f"chunks {res['chunks']}; K2 launches {l4} in both")
    return {"launches": l4, "chunks": res["chunks"]}


def dispatch_remat(torch, card):
    """(c) remat = 1 against 0, AlexNet.conf b256 bfloat16, 2 updates:
    params bitwise, or no further apart than two remat = 0 runs are;
    peak device memory lower; K1-fwd launched twice as often."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    say("== phase 15c: remat = 1 against 0, AlexNet.conf b256 bfloat16, 2 "
        "updates ==")
    rng = np.random.RandomState(16)
    host = [DataBatch(data=(rng.rand(256, 3, 227, 227) * 255).astype(
        np.float32), label=rng.randint(0, 1000, (256, 1)).astype(
        np.float32)) for _ in range(2)]
    out = {}
    bits = {}
    for tag, remat in (("remat0", 0), ("remat0b", 0), ("remat1", 1)):
        tr = alexnet_trainer([f"remat={remat}"])
        staged = [tr.stage_batch(b) for b in host]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for s in staged:
            tr.update(s)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        bits[tag] = _state_bits(torch, tr)
        out[tag] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                    "peak_over_state_bytes":
                        torch.cuda.max_memory_allocated() - base,
                    "step_ms": ms, "launches": kernels.launches(),
                    "segments": [[r.start, r.stop] for r in
                                 (tr._remat_segments or [])]}
        del tr, staged
        torch.cuda.empty_cache()

    def diff(x, y):
        return max(float(np.abs(a - b).max())
                   for a, b in zip(bits[x], bits[y]))
    d00, d01 = diff("remat0", "remat0b"), diff("remat1", "remat0")
    out["max_abs_diff_remat0_runs"] = d00
    out["max_abs_diff_remat1_vs_0"] = d01
    out["bitwise"] = _bits_equal(bits["remat1"], bits["remat0"])
    say(f"remat = 1 against 0: max |diff| {d01:g} (two remat = 0 runs: "
        f"{d00:g}), bitwise {out['bitwise']}; peak memory "
        f"{out['remat1']['peak_bytes'] / 2**20:.1f} MiB against "
        f"{out['remat0']['peak_bytes'] / 2**20:.1f} MiB (above the "
        f"trainer's state: {out['remat1']['peak_over_state_bytes'] / 2**20:.1f}"
        f" against {out['remat0']['peak_over_state_bytes'] / 2**20:.1f}); "
        f"{out['remat1']['step_ms']:.3f} against "
        f"{out['remat0']['step_ms']:.3f} ms a step; segments "
        f"{out['remat1']['segments']}; K1-fwd "
        f"{out['remat1']['launches']['lrn_fwd']} against "
        f"{out['remat0']['launches']['lrn_fwd']} in 2 steps on {card}")
    if d01 > d00:
        raise AssertionError("remat = 1 moved the params further than two "
                             "remat = 0 runs differ")
    if not out["remat1"]["peak_bytes"] < out["remat0"]["peak_bytes"]:
        raise AssertionError("remat = 1 did not lower the peak memory")
    if (out["remat0"]["launches"]["lrn_fwd"],
            out["remat1"]["launches"]["lrn_fwd"]) != (4, 8):
        raise AssertionError("K1-fwd: 2 a step, twice that under remat")
    return out


def dispatch_profile_cli(d):
    """(d) AlexNet.conf through the CLI for 2 rounds with profile = 1,
    profile_dir and trace_round = 2 (a fresh process): the summary lines,
    exactly one trace holding K1's kernels, `round` events."""
    say("== phase 15d: AlexNet.conf through the CLI, profile_dir, "
        "trace_round = 2 ==")
    from cxxnet_tpu_torch.telemetry.sink import read_jsonl
    work = os.path.join(d, "profile15")
    os.makedirs(os.path.join(work, "models"))
    # the CLI makes its own mean image (10c, which makes one of the same
    # set, may be writing it beside this run)
    os.symlink(os.path.join(d, "shared", "data"), os.path.join(work, "data"))
    prof = os.path.join(work, "prof")
    log = os.path.join(work, "events.jsonl")
    t0 = time.perf_counter()
    proc = run_cli([os.path.join(IMAGENET_CONFS, "AlexNet.conf"),
                    "num_round=2", "max_round=2", "profile=1",
                    f"profile_dir={prof}", "trace_round=2",
                    f"log_file={log}"], cwd=work)
    secs = time.perf_counter() - t0
    lines = [ln for ln in proc.stderr.splitlines() if "profile:" in ln]
    files = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    if len(lines) != 2 or files != ["trace_round2.json"]:
        raise AssertionError(f"profile lines {lines}, traces {files}:\n"
                             f"{proc.stderr[-3000:]}")
    with open(os.path.join(prof, files[0])) as f:
        kernels_seen = [e.get("name", "") for e in
                        json.load(f)["traceEvents"]
                        if e.get("cat") == "kernel"]
    n_fwd = sum("lrn_fwd" in n for n in kernels_seen)
    n_bwd = sum("lrn_bwd" in n for n in kernels_seen)
    rounds = [e for e in read_jsonl(log) if e.get("kind") == "round"]
    if n_fwd <= 0 or n_bwd <= 0 or [e["round"] for e in rounds] != [1, 2]:
        raise AssertionError(f"trace lrn_fwd {n_fwd} lrn_bwd {n_bwd}, "
                             f"round events {rounds}")
    for ln in lines:
        say("  " + ln.strip())
    say(f"one trace ({files[0]}): {len(kernels_seen)} kernel events, "
        f"lrn_fwd {n_fwd}, lrn_bwd {n_bwd}; round events "
        f"{[{k: e[k] for k in ('round', 'steps', 'step_p50_ms')} for e in rounds]}"
        f"; {secs:.1f} s")
    return {"profile_lines": lines, "trace_kernels": len(kernels_seen),
            "trace_lrn_fwd": n_fwd, "trace_lrn_bwd": n_bwd,
            "rounds": [{k: e[k] for k in ("round", "steps", "examples",
                                          "step_p50_ms", "images_per_sec")}
                       for e in rounds]}


def dispatch_tuning(torch, card):
    """(e) tools/autotune.py over a small space on MNIST_CONV.conf writes
    a "gpu" entry; the CLI (in this process) takes steps_per_dispatch
    from it; an explicit key beats it."""
    import contextlib
    import io
    from cxxnet_tpu_torch import main as port_main
    from cxxnet_tpu_torch.nnet import tuning
    from cxxnet_tpu_torch.telemetry.sink import read_jsonl
    from cxxnet_tpu_torch.tools import autotune, fused_smoke
    say("== phase 15e: the tuning cache - autotune on MNIST_CONV.conf, the "
        "CLI applies it ==")
    with tempfile.TemporaryDirectory() as d:
        tc = os.path.join(d, "tc.json")
        t0 = time.perf_counter()
        rc = autotune.main(["--conf", MNIST_CONV_CONF, "--budget-secs", "8",
                            "--serve", "0", "--per-layer", "0", "--grid-k",
                            "1,4", "--grid-prefetch", "1", "--out", tc])
        if rc != 0:
            raise AssertionError(f"autotune exited {rc}")
        entry = tuning.platform_entry(tc, "gpu")
        k = int(entry["knobs"]["steps_per_dispatch"])
        say(f"autotune: {time.perf_counter() - t0:.1f} s, gpu entry "
            f"{entry['knobs']}, grid {entry['measured']['grid']} images/s, "
            f"device_kind {entry['device_kind']!r}")
        os.makedirs(os.path.join(d, "data"))
        fused_smoke.write_digits(os.path.join(d, "data"), 1000, 3, "train")
        fused_smoke.write_digits(os.path.join(d, "data"), 200, 4, "t10k")
        got = {}
        cwd = os.getcwd()
        os.chdir(d)
        try:
            for tag, extra in (("cache", []),
                               ("explicit", ["steps_per_dispatch=2"])):
                log = os.path.join(d, f"{tag}.jsonl")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = port_main.main(
                        [MNIST_CONV_CONF, "num_round=1", "max_round=1",
                         f"tuning_cache={tc}", f"log_file={log}",
                         f"model_dir={d}/m_{tag}"] + extra)
                if rc != 0:
                    raise AssertionError(f"the CLI exited {rc}")
                m = re.search(r"tuning_cache: applied (.*)", buf.getvalue())
                chunks = [e["steps"] for e in read_jsonl(log)
                          if e.get("name") == "train.chunk"]
                got[tag] = (m.group(1) if m else "", chunks)
                say(f"CLI {tag}: applied '{got[tag][0]}', chunk sizes "
                    f"{sorted(set(chunks))} ({len(chunks)} chunks)")
        finally:
            os.chdir(cwd)
        applied, chunks = got["cache"]
        if f"steps_per_dispatch={k}" not in applied or (
                k > 1 and (not chunks or max(chunks) != k)) or (
                k == 1 and chunks):
            raise AssertionError(f"the CLI did not take K = {k}: {got}")
        applied, chunks = got["explicit"]
        if "steps_per_dispatch" in applied or not chunks or max(chunks) != 2:
            raise AssertionError(f"the explicit key did not win: {got}")
        return {"knobs": entry["knobs"], "grid": entry["measured"]["grid"],
                "cli_applied": got["cache"][0]}


def phase_dispatch(torch, card, d=None, clis="1"):
    """Phase 15 (see the module docstring); `d` is phase 10's directory
    (its shared imgbin set for (d)), or None to make a set here; `clis`
    "0" leaves (b) and (d) to the caller (the main flow runs them beside
    phase 10's CLI runs)."""
    t15 = time.perf_counter()
    secs = {}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out[key] = fn(*args)
        secs[key] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()

    out = {}
    timed("alexnet", dispatch_alexnet, torch, card)
    timed("remat", dispatch_remat, torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        if d is None:
            fmt, _pil = image_format_used()
            d = tmp
            shared = os.path.join(d, "shared")
            write_image_set(shared, "data/resize256", "data/train", 512, 256,
                            10, 11, fmt)
            write_image_set(shared, "data/resize256_test", "data/test", 256,
                            256, 10, 12, fmt)
        # (b) and (d) are CLI children that check and time nothing: side
        # by side
        if clis == "1":
            timed("seq_profile_cli", lambda: side_by_side(
                lambda: dispatch_seq_cli(torch, card),
                lambda: dispatch_profile_cli(d)))
            out["seq_cli"], out["profile_cli"] = out.pop("seq_profile_cli")
    timed("tuning", dispatch_tuning, torch, card)
    out["secs"] = secs
    say(f"phase 15 took {time.perf_counter() - t15:.1f} s ({secs})")
    say("phase 15 summary " + json.dumps(out, default=float))
    return out


# phase 11's profiled legs, each run in a fresh python process: in a
# long-lived process torch.profiler can lose the card's kernel events
# (PERF.md §7), and these legs must report device times
def leg_image_timing(torch, card, d, fmt):
    """Phase 10g as a leg: the timing set under `d` (phase 10's temporary
    directory, which outlives the leg's process), images in `fmt`."""
    return phase_image_timing(torch, d, fmt, card)


# ---------------------------------------------------------------------------
# phase 16: the analysis tier and the tools
# ---------------------------------------------------------------------------

def tool_cmd(module: str, *args: str):
    return [sys.executable, "-m", module, *args]


def run_procs(cmds, timeout: float):
    """Start every (label, argv, log path) at once, wait for all under one
    time limit, kill what is left at the limit; returns {label: (exit
    code or None when killed, seconds)}."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {}
    t0 = time.perf_counter()
    for label, argv, log in cmds:
        fh = open(log, "w")
        procs[label] = (subprocess.Popen(argv, stdout=fh,
                                         stderr=subprocess.STDOUT,
                                         cwd=REPO, env=env), fh)
    out = {}
    try:
        for label, (p, fh) in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                rc = p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                rc = None
            out[label] = (rc, time.perf_counter() - t0)
    finally:
        for p, fh in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            fh.close()
    return out


def tail(path: str, n: int = 30) -> str:
    with open(path) as f:
        return "".join(f.readlines()[-n:])


def phase_analysis(torch, card, *args, beside=None):
    """16: the graph and lock audits and the tools on the card (see the
    module docstring); returns the audits' counts and the tools' times.
    `beside`, a function, runs side by side with 16a-c (work that checks
    and times nothing)."""
    t16 = time.perf_counter()
    from cxxnet_tpu_torch import kernels
    kernels.build_all()   # built by phase 2; run as a leg, built here
    say("== phase 16a-c: the graph audit, the lock audit (serve-storm, "
        "native-decode, seeded inversion) and pass_smoke on the card, side "
        "by side ==")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        rep, seeded = os.path.join(d, "audit.json"), os.path.join(
            d, "seeded.json")
        logs = {k: os.path.join(d, f"{k}.log")
                for k in ("audit", "seeded", "serve_http", "pass")}
        def audits():
            return run_procs(cmds, timeout=300)

        cmds = [
            ("audit", tool_cmd("cxxnet_tpu_torch.analysis", "--dev", "cuda",
                               "--graph-audit", "--lock-audit",
                               "--lock-audit-scenarios",
                               "serve-storm,native-decode", "--json", rep),
             logs["audit"]),
            ("seeded", tool_cmd("cxxnet_tpu_torch.analysis", "--dev", "cuda",
                                "--lock-audit", "--lock-audit-scenarios",
                                "prefetch-round", "--seed-inversion",
                                "--json", seeded), logs["seeded"]),
            ("pass", tool_cmd("cxxnet_tpu_torch.tools.pass_smoke", "--dev",
                              "cuda", "--out", os.path.join(d, "pass")),
             logs["pass"])]
        res = audits() if beside is None else side_by_side(audits,
                                                           beside)[0]
        want = {"audit": 0, "seeded": 1, "pass": 0}
        for label, (rc, secs) in res.items():
            say(f"{label}: exit {rc} after {secs:.1f} s")
        for label, (rc, secs) in res.items():
            if rc != want[label]:
                raise AssertionError(
                    f"phase 16 {label}: exit code {rc}, want "
                    f"{want[label]}:\n{tail(logs[label], 60)}")
        with open(rep) as f:
            report = json.load(f)
        with open(seeded) as f:
            seeded_rep = json.load(f)["lock_audit"]
        audit, lock = report["audit"], report["lock_audit"]
        bad = [c for c in audit["checks"] + lock["checks"] if not c["ok"]]
        if bad or audit["platform"] != "gpu":
            raise AssertionError(f"phase 16: audit checks failed: {bad}")
        routing = [c for c in audit["checks"]
                   if c["check"] == "kernel-routing"]
        # 4 single-device paths, and the seq audit's ring and Ulysses
        # steps on each of two ranks
        if len(routing) != 8:
            raise AssertionError(f"phase 16a: {len(routing)} kernel-routing "
                                 "checks, want 8")
        for c in routing:
            say(f"16a kernel-routing {c['target']}: {c['detail']}")
        for c in audit["checks"]:
            if c["target"].startswith("train_chunk[K=4,check_nan=1]") or \
                    c["check"] == "float-trace-vacuity-guard":
                say(f"16a {c['target']} {c['check']}: {c['detail']}")
        kr = audit["counts"]["kernel_routing"]
        say(f"16a graph audit: {len(audit['checks'])} checks passed on "
            f"{audit['device']}, deferred {[x['target'] for x in audit['deferred']]}; "
            f"launches read {json.dumps(kr)}")
        if seeded_rep["cycle"] is None or seeded_rep["failed"] < 1:
            raise AssertionError("phase 16b: the seeded inversion passed")
        say(f"16b lock audit: {len(lock['checks'])} checks passed "
            f"({lock['sites']} lock sites, {len(lock['edges'])} order "
            f"edges, no lock held across a card sync, {lock['elapsed_s']} s);"
            f" seeded inversion failed as it must: cycle "
            f"{' -> '.join(seeded_rep['cycle'])}")
        say("16c " + tail(logs["pass"], 1).strip())
        say(f"16a-c took {max(s for _, s in res.values()):.1f} s; {card}")
        say("== phase 16c: serve_http_smoke on the card, alone (its storm "
            "bounds latency on the client's clock, its client in a "
            "process of its own; heavy work beside it would move both "
            "legs) ==")
        (rc, secs), = run_procs([(
            "serve_http", tool_cmd("cxxnet_tpu_torch.tools.serve_http_smoke",
                                   "--dev", "cuda", "--out",
                                   os.path.join(d, "http")),
            logs["serve_http"])], timeout=240).values()
        if rc != 0:
            raise AssertionError(f"phase 16 serve_http: exit code {rc}:\n"
                                 f"{tail(logs['serve_http'], 60)}")
        say(f"16c {tail(logs['serve_http'], 1).strip()} in {secs:.1f} s; "
            f"{card}")
        say("== phase 16c-d: bench_pool (AlexNet's pools, b256 bfloat16) and "
            "bench_attn --quick (K2 and SDPA, (4,8,4096,128) bfloat16), each "
            "alone ==")
        benches = {}
        import contextlib
        import io
        from cxxnet_tpu_torch.tools import bench_attn, bench_pool
        for label, mod, args in (
                ("bench_pool", bench_pool, ["--steps", "20"]),
                ("bench_attn", bench_attn, ["--quick"])):
            # in this process (no other work on the card meanwhile): a
            # child would add its start-up and nothing to the timings
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(args + ["--dev", "cuda"])
            secs = time.perf_counter() - t0
            rows = [json.loads(ln) for ln in buf.getvalue().splitlines()
                    if ln.startswith("{")]
            if rc != 0 or not rows or any("error" in r for r in rows):
                raise AssertionError(f"phase 16 {label}: exit {rc}\n"
                                     f"{buf.getvalue()[-3000:]}")
            for r in rows:
                say(f"{label} {json.dumps(r)}")
            say(f"{label}: {len(rows)} lines in {secs:.1f} s; {card}")
            benches[label] = rows
    secs = time.perf_counter() - t16
    say(f"phase 16 took {secs:.1f} s")
    return {"kernel_routing": kr, "benches": benches, "secs": secs,
            "audit_checks": len(audit["checks"]),
            "lock_checks": len(lock["checks"])}


# ---------------------------------------------------------------------------
# phase 17: data parallelism - two ranks sharing the one card
# ---------------------------------------------------------------------------

DIST_CONF = os.path.join(REPO, "examples", "MNIST", "dist.conf")
DP_STEPS = 1
# the bfloat16 two-rank losses against the one-process run's (relative)
DP_BF16_LOSS_BAR = 1e-2


def dp_env(rank: int, n: int, port: int) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(CXN_COORDINATOR=f"127.0.0.1:{port}", CXN_NUM_WORKER=str(n),
               CXN_WORKER_RANK=str(rank), CXN_LOCAL_RANK=str(rank))
    return env


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dp_cli(d: str, dev: str):
    """examples/MNIST/dist.conf, unedited, under launch_dist -n 2 in d
    (whose ./data/ holds the synthetic idx files), 2 rounds on `dev`,
    test_on_server = 1."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.launch_dist", "-n",
         "2", "--coordinator", f"127.0.0.1:{free_port()}", "--",
         sys.executable, "-m", "cxxnet_tpu_torch.main", DIST_CONF,
         "num_round=2", f"dev={dev}", "test_on_server=1"], cwd=d, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def dp_rounds(stderr: str):
    """The distinct `[N]\\ttrain-error:..\\ttest-error:..` lines (both
    ranks print each; they must agree)."""
    lines = sorted({ln for ln in stderr.splitlines()
                    if re.match(r"\[\d+\]\ttrain-error", ln)})
    by_round = {}
    for ln in lines:
        r = ln.split("]")[0]
        if r in by_round:
            raise AssertionError(f"the ranks printed different round lines: "
                                 f"{by_round[r]!r} / {ln!r}")
        by_round[r] = ln
    return [by_round[r] for r in sorted(by_round)]


def dp_dist_conf(work: str):
    """17a: dist.conf as two ranks on the card (gloo, dev = gpu:0) and the
    same job with dev = cpu, side by side; the card's round lines and
    rank 0's last checkpoint held to the CPU's."""
    import numpy as np
    from cxxnet_tpu_torch.nnet import checkpoint
    say("== phase 17a: examples/MNIST/dist.conf (param_server = dist, mesh "
        "= data:2, update_on_server = 1) under tools/launch_dist -n 2, "
        "dev = gpu:0 (both ranks on the card, gloo) against dev = cpu ==")
    dirs = {}
    for dev in ("gpu:0", "cpu"):
        d = os.path.join(work, dev.replace(":", ""))
        os.makedirs(os.path.join(d, "data"))
        write_mnist(os.path.join(d, "data"), 1000, 31, prefix="train")
        write_mnist(os.path.join(d, "data"), 500, 32)
        dirs[dev] = d
    t0 = time.perf_counter()
    procs = {dev: dp_cli(d, dev) for dev, d in dirs.items()}
    outs = {dev: p.communicate(timeout=600) for dev, p in procs.items()}
    secs = time.perf_counter() - t0
    for dev, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"dist.conf on {dev} exited {p.returncode}"
                                 f":\n{outs[dev][0]}\n{outs[dev][1]}")
    for ln in outs["gpu:0"][1].splitlines():
        if ln.startswith("param_server=dist"):
            say("  " + ln)
    rounds = {dev: dp_rounds(outs[dev][1]) for dev in dirs}
    if len(rounds["gpu:0"]) != 2 or len(rounds["cpu"]) != 2:
        raise AssertionError(f"expected 2 round lines each: {rounds}")
    worst_err = 0.0
    for lg, lc in zip(rounds["gpu:0"], rounds["cpu"]):
        vg = [float(t.split(":")[1]) for t in lg.split("\t")[1:]]
        vc = [float(t.split(":")[1]) for t in lc.split("\t")[1:]]
        worst_err = max(worst_err, *(abs(a - b) for a, b in zip(vg, vc)))
    models = {dev: sorted(os.listdir(os.path.join(d, "models")))
              for dev, d in dirs.items()}
    if models["gpu:0"] != models["cpu"] or not models["cpu"]:
        raise AssertionError(f"checkpoints differ: {models}")
    last = models["cpu"][-1]
    blobs = {}
    for dev, d in dirs.items():
        with open(os.path.join(d, "models", last), "rb") as f:
            blobs[dev] = checkpoint.load_model(f)["params"]
    worst = 0.0
    for lk, dd in blobs["cpu"].items():
        for pn, want in dd.items():
            got = blobs["gpu:0"][lk][pn]
            if not np.allclose(got, want, rtol=1e-3, atol=1e-5):
                raise AssertionError(f"{last} {lk}/{pn}: card vs CPU max abs "
                                     f"{np.abs(got - want).max():.3e}")
            worst = max(worst, float(np.abs(got - want).max()))
    if worst_err > 0.01:
        raise AssertionError(f"round lines differ by {worst_err} > 0.01: "
                             f"{rounds}")
    say(f"card: {rounds['gpu:0']}; CPU: {rounds['cpu']}")
    say(f"test_on_server = 1 held every round on both; the round lines "
        f"differ by at most {worst_err:g} (bar 0.01); rank 0's {last} "
        f"card vs CPU: max abs {worst:.3e} (rtol 1e-3, atol 1e-5); both "
        f"jobs side by side in {secs:.1f} s")
    return {"rounds_card": rounds["gpu:0"], "rounds_cpu": rounds["cpu"],
            "max_abs_checkpoint": worst, "max_round_diff": worst_err}


def dp_references(torch, work: str, images, labels):
    """The one-process b256 runs the two ranks are held to: float32 with
    the discrete decisions recorded (each rank's rows saved for its
    replay, and the whole batch's for ranks that feed every row), and
    bfloat16 losses. Same batch, same dropout masks."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.ops.routing import Routing
    batch = DataBatch(data=images, label=labels)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = alexnet_trainer(["dtype=float32"])
    before = {f"{k}/{n}": t.cpu().numpy().copy()
              for k, d in tr.state["params"].items() for n, t in d.items()}
    for i in range(DP_STEPS):
        rec = Routing()
        with rec:
            tr.update(batch, keep=numpy_keep(tr, seed=40 + i))
        for r in range(2):
            torch.save({k: v[r * 128:(r + 1) * 128].clone()
                        for k, v in rec.decisions.items()},
                       os.path.join(work, f"dec{i}_r{r}.pt"))
        torch.save(rec.decisions, os.path.join(work, f"dec{i}_full.pt"))
        del rec
    after = {f"{k}/{n}": t.cpu().numpy()
             for k, d in tr.state["params"].items() for n, t in d.items()}
    np.savez(os.path.join(work, "f32_ref.npz"),
             **{f"before:{k}": v for k, v in before.items()},
             **{f"after:{k}": v for k, v in after.items()})
    del tr, before, after
    torch.cuda.empty_cache()
    tr = alexnet_trainer([])
    losses = [float(tr.update(batch, keep=numpy_keep(tr, seed=40 + i)))
              for i in range(DP_STEPS)]
    del tr
    torch.cuda.empty_cache()
    return losses


def dp_count_plain(torch):
    """Count calls of what must not run on the main path: the plain
    versions of K1 and K2, F.local_response_norm and SDPA."""
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import flash_attention as FA
    from cxxnet_tpu_torch.ops import lrn as L
    calls = {}

    def wrap(mod, name):
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        setattr(mod, name, counted)
    for mod, name in ((F, "local_response_norm"),
                      (F, "scaled_dot_product_attention"),
                      (L, "lrn_reference"), (L, "lrn_bwd_reference"),
                      (FA, "flash_fwd_reference"),
                      (FA, "flash_bwd_reference")):
        wrap(mod, name)
    return calls


def dp_alexnet_leg(torch, dtype: str, uos: int, batch, rank: int, work):
    """One two-rank AlexNet.conf leg in this worker: DP_STEPS steps on
    this rank's 128 rows of the fixed b256 batch; float32 replays the
    one-process run's decisions and is held to its updates."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.ops.routing import Routing
    from cxxnet_tpu_torch.parallel import distributed
    over = ["param_server=dist", "dev=gpu:0", f"update_on_server={uos}"]
    if dtype == "float32":
        over.append("dtype=float32")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    tr = alexnet_trainer(over)
    lb, lo = tr._local_batch, tr._local_row_start
    if (lb, tr._dsize, str(tr.device)) != (128, 2, "cuda:0"):
        raise AssertionError(f"rank {rank}: b{lb} of {tr._dsize} ranks on "
                             f"{tr.device}")
    mine = DataBatch(data=batch.data[lo:lo + lb],
                     label=batch.label[lo:lo + lb])
    start = {f"{k}/{n}": t.cpu().numpy().copy()
             for k, d in tr.state["params"].items() for n, t in d.items()}
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses, step_ms = [], []
    for i in range(DP_STEPS):
        keep = {j: m[lo:lo + lb]
                for j, m in numpy_keep(tr, seed=40 + i).items()}
        if dtype == "float32":
            rec = Routing()
            rec.decisions = torch.load(os.path.join(work,
                                                    f"dec{i}_r{rank}.pt"))
        t0 = time.perf_counter()
        if dtype == "float32":
            with Routing(replay=rec):
                loss = tr.update(mine, keep=keep)
        else:
            loss = tr.update(mine, keep=keep)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launches()
    out = {"dtype": dtype, "update_on_server": uos, "losses": losses,
           "step_ms": step_ms, "counts": counts,
           "ustate_bytes": tr.ustate_bytes(),
           "check_weights": tr.check_weights()}
    if tr._zero is not None:
        out["cut_state_bytes"] = sum(
            t.numel() * t.element_size() for lk, pn, _, _ in tr._zero.cut
            for t in tr.state["ustate"][lk][pn].values())
        out["cut_weights"] = [f"{lk}/{pn}" for lk, pn, _, _ in tr._zero.cut]
    # the all-reduce the step runs: one float32 buffer of every gradient
    # element (and the loss), timed alone
    n = 1 + sum(t.numel() for d in tr.state["params"].values()
                for t in d.values())
    buf = torch.zeros(n, device=tr.device)
    ar = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        distributed.all_reduce_(buf)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = sorted(ar)[1]
    out["allreduce_mib"] = n * 4 / 2 ** 20
    z = tr._zero
    if z is not None:
        # ZeRO-1's all-gather of the fresh cut weights (staged through
        # pinned host memory under gloo), timed alone as the all-reduce
        master = tr.state["params"]
        mine_w = {(lk, pn): z.owned(master[lk][pn], lk, pn)
                  for lk, pn, _, _ in z.cut}
        into = {(lk, pn): torch.empty_like(master[lk][pn])
                for lk, pn, _, _ in z.cut}
        ag = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z.gather(mine_w, into)
            torch.cuda.synchronize()
            ag.append((time.perf_counter() - t0) * 1e3)
        out["allgather_ms"] = sorted(ag)[1]
        out["allgather_mib"] = sum(t.numel() * 4 for t in into.values()
                                   ) / 2 ** 20
        del mine_w, into
    if dtype == "float32":
        ref = np.load(os.path.join(work, "f32_ref.npz"))
        worst, worst_key = 0.0, ""
        for k, b in start.items():
            if not np.array_equal(b, ref[f"before:{k}"]):
                raise AssertionError(f"{k}: the two-rank and one-process "
                                     "runs started from different weights")
            d_ref = ref[f"after:{k}"] - b
            d_dp = tr.state["params"][k.split("/")[0]][
                k.split("/")[1]].cpu().numpy() - b
            den = float(np.linalg.norm(d_ref))
            rel = float(np.linalg.norm(d_dp - d_ref)) / den if den else 0.0
            if rel > worst:
                worst, worst_key = rel, k
        out["f32_worst_update_rel"] = worst
        out["f32_worst_key"] = worst_key
    del tr, start
    torch.cuda.empty_cache()
    return out


def dp_seq_leg(torch, rank: int):
    """17c: seq_mnist.conf as two ranks on the card, DP_STEPS steps."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    tr = seq_trainer(["param_server=dist", "dev=gpu:0"])
    lb, lo = tr._local_batch, tr._local_row_start
    rng = np.random.RandomState(21)
    images = rng.rand(100, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=(100, 1)).astype(np.float32)
    mine = DataBatch(data=images[lo:lo + lb], label=labels[lo:lo + lb])
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses = [float(tr.update(mine)) for _ in range(DP_STEPS)]
    return {"rows": lb, "losses": losses, "counts": kernels.launches(),
            "check_weights": tr.check_weights()}


def leg_dp_worker(torch, card, work):
    """A rank of phase 17b/17c (`chip_smoke.py --leg 17w OUT WORK`, under
    the CXN_* variables phase 17 sets): the four AlexNet.conf legs, then
    seq_mnist.conf; the result is also printed as one `dp-result` line."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    rank = int(os.environ["CXN_WORKER_RANK"])
    calls = dp_count_plain(torch)
    z = np.load(os.path.join(work, "batch.npz"))
    batch = DataBatch(data=z["images"], label=z["labels"])
    legs = [dp_alexnet_leg(torch, dt, uos, batch, rank, work)
            for dt, uos in (("float32", 0), ("float32", 1),
                            ("bfloat16", 0), ("bfloat16", 1))]
    seq = dp_seq_leg(torch, rank)
    from cxxnet_tpu_torch.parallel import distributed
    out = {"rank": rank, "alexnet": legs, "seq": seq, "plain_calls": calls,
           "backend": distributed.backend(),
           "host_staged": distributed.host_staged[0]}
    sys.stdout.write("dp-result " + json.dumps(out) + "\n")
    sys.stdout.flush()
    return out


def dp_workers(work: str, leg: str = "17w", args=(),
               prefix: str = "dp-result ", timeout: float = 600.0,
               n: int = 2, threads: str = ""):
    """`n` ranks (two by default) of a worker leg (`--leg 17w WORK` for
    phase 17b-c, `--leg 18w WORK MODE` for phase 18), their lines
    printed as they come; when one fails the others are killed at once
    (they would wait in a collective for their peer). `threads` sets
    OMP_NUM_THREADS of each rank. Returns each rank's result: its last
    line that starts with `prefix`, as JSON."""
    port = free_port()

    def env(r):
        e = dp_env(r, n, port)
        if threads:
            e["OMP_NUM_THREADS"] = threads
        return e
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--leg", leg,
         os.path.join(work, f"{leg}{''.join(args)}{r}.json"), work, *args],
        env=env(r), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = [[] for _ in range(n)]

    def pump(r):
        for ln in procs[r].stdout:
            ln = ln.rstrip("\n")
            outs[r].append(ln)
            # a worker's result lines are read, not printed
            if not ln.startswith((prefix, "dp-result ", "tz-result ")):
                say(f"  rank {r}: {ln}")

    readers = [threading.Thread(target=pump, args=(r,), daemon=True)
               for r in range(n)]
    for t in readers:
        t.start()
    end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > end):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for t in readers:
        t.join(timeout=10)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"leg {leg} {' '.join(args)} rank {r} "
                                 f"exited {p.returncode}")
    return [json.loads([ln for ln in out if ln.startswith(prefix)][-1]
                       [len(prefix):]) for out in outs]


def dp_batch(work: str):
    """The fixed global b256 batch of phases 17 and 18, saved in work."""
    import numpy as np
    rng = np.random.RandomState(17)
    images = (rng.rand(256, 3, 227, 227) * 255.0 - 128.0).astype(np.float32)
    labels = rng.randint(0, 1000, size=(256, 1)).astype(np.float32)
    np.savez(os.path.join(work, "batch.npz"), images=images, labels=labels)
    return images, labels


def phase_data_parallel(torch, card, work=None, results=None):
    """Phase 17 (`chip_smoke.py --leg 17 OUT [WORK]`): 17a dist.conf
    through the CLI, 17b AlexNet.conf at global b256 and 17c
    seq_mnist.conf as two ranks in spawned workers sharing the card over
    gloo. With WORK, 17a's result and the one-process references are
    the ones phase 18's untimed leg left there (`--leg 18u`); alone, 17a
    and the references run here, side by side. `results`: the workers'
    results when they ran already (the whole script's `--leg 1718w`)."""
    import numpy as np
    t17 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if work is None:
            work = stack.enter_context(tempfile.TemporaryDirectory())
            images, labels = dp_batch(work)
            # 17a's CLI jobs and the references time nothing: side by side
            cli, ref_losses = side_by_side(
                lambda: dp_dist_conf(work),
                lambda: dp_references(torch, work, images, labels))
        else:
            with open(os.path.join(work, "untimed.json")) as f:
                pre = json.load(f)
            cli, ref_losses = pre["cli"], pre["ref_losses"]
        say("== phase 17b: AlexNet.conf at full width, global batch 256 "
            "(128 a rank), two ranks sharing the card (gloo), "
            f"{DP_STEPS} steps at update_on_server = 0 and 1, float32 and "
            "bfloat16, against one process at b256 ==")
        if results is None:
            results = dp_workers(work)
    per_step = {"lrn_fwd": 2, "lrn_bwd": 2}
    for res in results:
        r = res["rank"]
        if any(res["plain_calls"].values()):
            raise AssertionError(f"rank {r} called plain versions: "
                                 f"{res['plain_calls']}")
        for leg in res["alexnet"]:
            want = {n: DP_STEPS * per_step.get(n, 0) for n in leg["counts"]}
            if leg["counts"] != want or leg["check_weights"]:
                raise AssertionError(f"rank {r} {leg['dtype']} uos "
                                     f"{leg['update_on_server']}: launches "
                                     f"{leg['counts']} (want {want}), "
                                     f"check_weights {leg['check_weights']}")
            if not all(np.isfinite(leg["losses"])):
                raise AssertionError(f"rank {r}: non-finite {leg['losses']}")
            if leg["dtype"] == "float32":
                if leg["f32_worst_update_rel"] > UPDATE_BAR:
                    raise AssertionError(
                        f"rank {r} float32 uos {leg['update_on_server']}: "
                        f"{leg['f32_worst_key']}'s update differs by "
                        f"{leg['f32_worst_update_rel']:.3e} of its norm > "
                        f"{UPDATE_BAR}")
            else:
                rel = max(abs(a - b) / abs(b) for a, b in
                          zip(leg["losses"], ref_losses))
                leg["loss_rel_vs_one_process"] = rel
                if rel > DP_BF16_LOSS_BAR:
                    raise AssertionError(
                        f"rank {r} bfloat16: losses {leg['losses']} vs one "
                        f"process {ref_losses} (bar {DP_BF16_LOSS_BAR})")
        seq = res["seq"]
        want = {n: DP_STEPS * (1 if n in K2 else 0) for n in seq["counts"]}
        if seq["counts"] != want or seq["check_weights"]:
            raise AssertionError(f"rank {r} seq_mnist: launches "
                                 f"{seq['counts']} (want {want}), "
                                 f"check_weights {seq['check_weights']}")
    a0, a1 = (results[0]["alexnet"], results[1]["alexnet"])
    for leg0, leg1 in zip(a0, a1):
        if leg0["losses"] != leg1["losses"]:
            raise AssertionError(f"the ranks' global losses differ: "
                                 f"{leg0['losses']} / {leg1['losses']}")
    z0 = {leg["update_on_server"]: leg for leg in a0
          if leg["dtype"] == "bfloat16"}
    cut0 = z0[1]["cut_state_bytes"]
    full_cut = 2 * cut0
    say(f"backend {results[0]['backend']}; collectives staged through "
        f"pinned host memory per rank: {results[0]['host_staged']}")
    for leg in a0:
        say(f"rank 0 {leg['dtype']} update_on_server = "
            f"{leg['update_on_server']}: losses "
            f"{[round(v, 5) for v in leg['losses']]}, step ms "
            f"{[round(v, 1) for v in leg['step_ms']]}, all-reduce of "
            f"{leg['allreduce_mib']:.1f} MiB {leg['allreduce_ms']:.1f} ms, "
            + (f"ZeRO-1 all-gather of {leg['allgather_mib']:.1f} MiB "
               f"{leg['allgather_ms']:.1f} ms, " if "allgather_ms" in leg
               else "")
            + f"updater state {leg['ustate_bytes'] / 2 ** 20:.1f} MiB"
            + (f", worst update {leg['f32_worst_key']} "
               f"{leg['f32_worst_update_rel']:.3e} of its norm (bar "
               f"{UPDATE_BAR})" if leg["dtype"] == "float32" else
               f", loss vs one process {leg['loss_rel_vs_one_process']:.2e}"
               f" (bar {DP_BF16_LOSS_BAR})"))
    say(f"one process b256: bfloat16 losses "
        f"{[round(v, 5) for v in ref_losses]}")
    say(f"ZeRO-1: the cut weights' updater state a rank holds: "
        f"{full_cut / 2 ** 20:.1f} MiB at update_on_server = 0, "
        f"{cut0 / 2 ** 20:.1f} MiB at 1 ({cut0 / full_cut:.3f}); "
        f"{len(z0[1]['cut_weights'])} cut weights")
    say("times are of two ranks sharing one card (gloo), not a multi-GPU "
        f"scaling figure; {card}")
    say("== phase 17c: seq_mnist.conf as two ranks on the card ==")
    for res in results:
        seq = res["seq"]
        say(f"rank {res['rank']}: {seq['rows']} rows a step, launches "
            f"{ {n: c for n, c in seq['counts'].items() if c} } over "
            f"{DP_STEPS} steps (K2 1-1-1 a step), no SDPA and no plain "
            f"version; losses {[round(v, 5) for v in seq['losses']]}")
    secs = time.perf_counter() - t17
    say(f"phase 17 took {secs:.1f} s")
    return {"cli": cli, "ranks": results, "ref_losses": ref_losses,
            "secs": secs}



# ---------------------------------------------------------------------------
# phase 18: ZeRO stages 2-3 and the model axis - ranks sharing the one card
# ---------------------------------------------------------------------------

MNIST_CONV = os.path.join(REPO, "examples", "MNIST", "MNIST_CONV.conf")
# taken out of MNIST_CONV.conf for 18d: dropout draws from each device's
# own generator (Philox on the card, the CPU's mt19937), so with it the
# card's and the CPU's jobs would train on different masks
MNIST_CONV_DROPOUT = "layer[3->3] = dropout\n  threshold = 0.5\n"


def tz_median_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock ms of a synchronised collective."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def tz_alexnet_leg(torch, dtype: str, stage: int, mesh: str, batch,
                   rank: int, work):
    """One AlexNet.conf leg of phase 18 in this worker: DP_STEPS steps of
    the fixed b256 batch (this rank's rows: its data index's 128 on
    data:2, all 256 on model:2); float32 replays the one-process run's
    decisions and is held to its updates. Reports the bytes this rank
    holds and, under a ZeRO cut, the collectives' times."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.ops.routing import Routing
    over = ["param_server=dist", "dev=gpu:0", f"mesh={mesh}",
            f"zero_stage={stage}"]
    if dtype == "float32":
        over.append("dtype=float32")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    tr = alexnet_trainer(over)
    lb, lo = tr._local_batch, tr._local_row_start
    want = (128, 2, 1) if mesh == "data:2" else (256, 1, 2)
    if ((lb, tr._dsize, tr._msize) != want
            or str(tr.device) != "cuda:0"):
        raise AssertionError(f"rank {rank} {mesh}: b{lb}, data "
                             f"{tr._dsize} x model {tr._msize} on "
                             f"{tr.device}")
    mine = DataBatch(data=batch.data[lo:lo + lb],
                     label=batch.label[lo:lo + lb])
    start = tr._host_params() if dtype == "float32" else None
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses, step_ms = [], []
    for i in range(DP_STEPS):
        keep = {j: m[lo:lo + lb]
                for j, m in numpy_keep(tr, seed=40 + i).items()}
        t0 = time.perf_counter()
        if dtype == "float32":
            rec = Routing()
            rec.decisions = torch.load(os.path.join(
                work, f"dec{i}_full.pt" if lb == 256
                else f"dec{i}_r{lo // lb}.pt"))
            with Routing(replay=rec):
                loss = tr.update(mine, keep=keep)
        else:
            loss = tr.update(mine, keep=keep)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launches()
    out = {"dtype": dtype, "stage": tr._zero_run, "mesh": mesh,
           "losses": losses, "step_ms": step_ms, "counts": counts,
           "bytes": tr.state_bytes(), "check_weights": tr.check_weights()}
    z = tr._zero
    if z is not None:
        # the step's collectives on the cut weights, timed alone: the
        # reduce-scatter of their gradients (stage >= 2) and the
        # all-gather of the weights (after the update at stages 1-2,
        # before the forward at 3)
        local = tr._local_shapes
        cut = {(lk, pn): torch.zeros(local[lk][pn], device=tr.device)
               for lk, pn, _, _ in z.cut}
        if tr._zero_run >= 2:
            out["reduce_scatter_ms"] = tz_median_ms(
                torch, lambda: z.reduce_scatter(cut))
            out["reduce_scatter_mib"] = sum(
                t.numel() * 4 for t in cut.values()) / 2 ** 20
        slices = {key: z.owned(t, *key) for key, t in cut.items()}
        out["allgather_ms"] = tz_median_ms(
            torch, lambda: z.gather(slices, cut))
        out["allgather_mib"] = sum(t.numel() * 4
                                   for t in cut.values()) / 2 ** 20
        del cut, slices
    if tr._mcut is not None:
        local = sum(t.numel() * t.element_size()
                    for lk, d in tr.state["params"].items()
                    for pn, t in d.items() if lk.startswith(("conv", "fc")))
        whole = sum(int(np.prod(s)) * 4
                    for lk, d in tr.net.param_shapes().items()
                    for s in d.values() if lk.startswith(("conv", "fc")))
        out["conv_fc_bytes"], out["conv_fc_whole_bytes"] = local, whole
    if dtype == "float32":
        after = tr._host_params()
        ref = np.load(os.path.join(work, "f32_ref.npz"))
        worst, worst_key = 0.0, ""
        for lk, d in start.items():
            for pn, b in d.items():
                k = f"{lk}/{pn}"
                if not np.array_equal(b, ref[f"before:{k}"]):
                    raise AssertionError(f"{k}: the ranks and the one-"
                                         "process run started apart")
                d_ref = ref[f"after:{k}"] - b
                d_tz = after[lk][pn] - b
                den = float(np.linalg.norm(d_ref))
                rel = (float(np.linalg.norm(d_tz - d_ref)) / den if den
                       else 0.0)
                if rel > worst:
                    worst, worst_key = rel, k
        out["f32_worst_update_rel"] = worst
        out["f32_worst_key"] = worst_key
        del after
    del tr, start
    torch.cuda.empty_cache()
    return out


def tz_seq_leg(torch, rank: int):
    """18c: seq_mnist.conf (nhead 4) at model:2, each rank on all 100
    rows, DP_STEPS steps: K2 on this rank's 2 heads."""
    import numpy as np
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.data import DataBatch
    tr = seq_trainer(["param_server=dist", "dev=gpu:0", "mesh=model:2"])
    rng = np.random.RandomState(21)
    batch = DataBatch(data=rng.rand(100, 1, 28, 28).astype(np.float32),
                      label=rng.randint(0, 10, size=(100, 1)).astype(
                          np.float32))
    att = [lay for lay in tr.net.layer_objs if lay.type_name == "attention"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses = [float(tr.update(batch)) for _ in range(DP_STEPS)]
    return {"rows": tr._local_batch, "losses": losses,
            "counts": kernels.launches(), "nhead": [a.nhead for a in att],
            "check_weights": tr.check_weights()}


def leg_all_worker(torch, card, work):
    """A rank of phases 17b-c, 18a and 19b (`chip_smoke.py --leg 1718w
    OUT WORK`, the whole script's one pair of workers for them): 17b-c
    (leg_dp_worker), then 18a with 19b after it (leg_tz_worker, MODE
    zerosp), one after the other - each alone on the card as when its
    phase runs its own workers. The results are also printed as one
    `all-result` line."""
    out = {"dp": leg_dp_worker(torch, card, work),
           "tz": leg_tz_worker(torch, card, work, "zerosp")}
    sys.stdout.write("all-result " + json.dumps(out) + "\n")
    sys.stdout.flush()
    return out


def leg_tz_worker(torch, card, work, mode):
    """A rank of phase 18 (`chip_smoke.py --leg 18w OUT WORK MODE`, under
    the CXN_* variables phase 18 sets): MODE zero - AlexNet.conf at
    data:2 under zero_stage 2 and 3 (float32) and 1 and 3 (bfloat16);
    MODE model - AlexNet.conf at model:2 (float32, bfloat16), then
    seq_mnist.conf at model:2; MODE zerosp - zero, then phase 19b
    (sp_rank) in the same two ranks."""
    import numpy as np
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.parallel import distributed, tensor
    rank = int(os.environ["CXN_WORKER_RANK"])
    calls = dp_count_plain(torch)
    z = np.load(os.path.join(work, "batch.npz"))
    batch = DataBatch(data=z["images"], label=z["labels"])
    sp = None
    if mode in ("zero", "zerosp"):
        legs = [tz_alexnet_leg(torch, dt, st, "data:2", batch, rank, work)
                for dt, st in (("float32", 2), ("float32", 3),
                               ("bfloat16", 1), ("bfloat16", 3))]
        seq = None
        if mode == "zerosp":
            # phase 19b, alone after 18a in the same two ranks
            torch.cuda.empty_cache()
            sp = sp_rank(torch, rank, calls)
    else:
        legs = [tz_alexnet_leg(torch, dt, 0, "model:2", batch, rank, work)
                for dt in ("float32", "bfloat16")]
        seq = tz_seq_leg(torch, rank)
    out = {"rank": rank, "alexnet": legs, "seq": seq, "plain_calls": calls,
           "backend": distributed.backend(),
           "host_staged": distributed.host_staged[0],
           "reduce_scatters": distributed.reduce_scatters[0],
           "tp_calls": dict(tensor.calls), "sp": sp}
    sys.stdout.write("tz-result " + json.dumps(out) + "\n")
    sys.stdout.flush()
    return out


def tz_mnist_conv(work: str):
    """18d: examples/MNIST/MNIST_CONV.conf at mesh = data:2,model:2 under
    zero_stage = 3, four ranks under launch_dist on the card (gloo, dev
    = gpu:0) beside the same job with dev = cpu, 2 rounds each,
    test_on_server = 1. The conf runs without its dropout layer, so both
    jobs train one function (each device draws its masks from its own
    generator); the round lines and rank 0's last checkpoint are held to
    the CPU's as 17a's are."""
    import numpy as np
    from cxxnet_tpu_torch.nnet import checkpoint
    with open(MNIST_CONV) as f:
        text = f.read()
    conf = os.path.join(work, "mnist_conv_nodrop.conf")
    with open(conf, "w") as f:
        f.write(text.replace(MNIST_CONV_DROPOUT, ""))
    if "dropout" in open(conf).read():
        raise AssertionError("MNIST_CONV.conf's dropout layer moved")
    dirs, procs = {}, {}
    # two threads a rank: the ranks (and the jobs beside them) would
    # oversubscribe the host's cores with torch's default
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    for dev in ("gpu:0", "cpu"):
        d = os.path.join(work, "conv_" + dev.replace(":", ""))
        os.makedirs(os.path.join(d, "data"))
        write_mnist(os.path.join(d, "data"), 1000, 33, prefix="train")
        write_mnist(os.path.join(d, "data"), 500, 34)
        dirs[dev] = d
        procs[dev] = subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch.tools.launch_dist",
             "-n", "4", "--coordinator", f"127.0.0.1:{free_port()}", "--",
             sys.executable, "-m", "cxxnet_tpu_torch.main", conf,
             "num_round=2", "max_round=2", "save_model=1", f"dev={dev}",
             "param_server=dist", "mesh=data:2,model:2", "zero_stage=3",
             "test_on_server=1"], cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    outs = {dev: p.communicate(timeout=600) for dev, p in procs.items()}
    secs = time.perf_counter() - t0
    say("== phase 18d: examples/MNIST/MNIST_CONV.conf (no dropout) at mesh "
        "= data:2,model:2, zero_stage = 3, four ranks under launch_dist, "
        "dev = gpu:0 (gloo) against dev = cpu ==")
    for dev, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"MNIST_CONV.conf on {dev} exited "
                                 f"{p.returncode}:\n{outs[dev][1][-3000:]}")
    rounds = {dev: dp_rounds(outs[dev][1]) for dev in dirs}
    if len(rounds["gpu:0"]) != 2 or len(rounds["cpu"]) != 2:
        raise AssertionError(f"expected 2 round lines each: {rounds}")
    worst_err = 0.0
    for lg, lc in zip(rounds["gpu:0"], rounds["cpu"]):
        vg = [float(t.split(":")[1]) for t in lg.split("\t")[1:]]
        vc = [float(t.split(":")[1]) for t in lc.split("\t")[1:]]
        worst_err = max(worst_err, *(abs(a - b) for a, b in zip(vg, vc)))
    blobs = {}
    for dev, d in dirs.items():
        with open(os.path.join(d, "models", "0002.model"), "rb") as f:
            blobs[dev] = checkpoint.load_model(f)["params"]
    worst = 0.0
    for lk, dd in blobs["cpu"].items():
        for pn, want in dd.items():
            got = blobs["gpu:0"][lk][pn]
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"0002.model {lk}/{pn}: shape "
                                     f"{got.shape} vs {want.shape} or "
                                     f"non-finite")
            if not np.allclose(got, want, rtol=1e-3, atol=1e-5):
                raise AssertionError(f"0002.model {lk}/{pn}: card vs CPU "
                                     f"max abs "
                                     f"{np.abs(got - want).max():.3e}")
            worst = max(worst, float(np.abs(got - want).max()))
    if worst_err > 0.01:
        raise AssertionError(f"round lines differ by {worst_err} > 0.01: "
                             f"{rounds}")
    say(f"card: {rounds['gpu:0']}; CPU: {rounds['cpu']}; test_on_server "
        f"= 1 held every round on the four ranks of both; the round lines "
        f"differ by at most {worst_err:g} (bar 0.01); rank 0's 0002.model "
        f"card vs CPU: max abs {worst:.3e} (rtol 1e-3, atol 1e-5); both "
        f"jobs side by side in {secs:.1f} s")
    return {"rounds_card": rounds["gpu:0"], "rounds_cpu": rounds["cpu"],
            "max_abs_checkpoint": worst, "max_round_diff": worst_err}


def tz_zero_smoke(work: str):
    """18e: the port's tools/zero_smoke.py on the card (four two-rank
    jobs side by side: stages 0, 2, 2 at steps_per_dispatch = 4, 3)."""
    d = os.path.join(work, "zero_smoke")
    os.makedirs(d)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(tool_cmd("cxxnet_tpu_torch.tools.zero_smoke", "--out",
                                d, "--dev", "gpu:0"), cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    say("== phase 18e: tools/zero_smoke.py --dev gpu:0 (stage 0, 2, 2 with "
        "steps_per_dispatch = 4, 3; two ranks each, on the card) ==")
    for ln in r.stdout.splitlines():
        say("  " + ln)
    if r.returncode != 0:
        raise AssertionError(f"zero_smoke exited {r.returncode}:\n"
                             f"{r.stderr[-2000:]}")
    return {"secs": time.perf_counter() - t0,
            "summary": r.stdout.strip().splitlines()[-1]}


def tz_held(torch, results, ref_losses, what: str):
    """The checks of one phase-18 job's two ranks."""
    import numpy as np
    per_step = {"lrn_fwd": 2, "lrn_bwd": 2}
    for res in results:
        r = res["rank"]
        if any(res["plain_calls"].values()):
            raise AssertionError(f"{what} rank {r} called plain versions: "
                                 f"{res['plain_calls']}")
        for leg in res["alexnet"]:
            want = {n: DP_STEPS * per_step.get(n, 0) for n in leg["counts"]}
            tag = f"{what} rank {r} {leg['dtype']} stage {leg['stage']}"
            if leg["counts"] != want or leg["check_weights"]:
                raise AssertionError(f"{tag}: launches {leg['counts']} "
                                     f"(want {want}), check_weights "
                                     f"{leg['check_weights']}")
            if not all(np.isfinite(leg["losses"])):
                raise AssertionError(f"{tag}: non-finite {leg['losses']}")
            if leg["dtype"] == "float32":
                if leg["f32_worst_update_rel"] > UPDATE_BAR:
                    raise AssertionError(
                        f"{tag}: {leg['f32_worst_key']}'s update differs "
                        f"by {leg['f32_worst_update_rel']:.3e} of its norm "
                        f"> {UPDATE_BAR}")
            else:
                rel = max(abs(a - b) / abs(b) for a, b in
                          zip(leg["losses"], ref_losses))
                leg["loss_rel_vs_one_process"] = rel
                if rel > DP_BF16_LOSS_BAR:
                    raise AssertionError(
                        f"{tag}: losses {leg['losses']} vs one process "
                        f"{ref_losses} (bar {DP_BF16_LOSS_BAR})")
    for leg0, leg1 in zip(results[0]["alexnet"], results[1]["alexnet"]):
        if leg0["losses"] != leg1["losses"]:
            raise AssertionError(f"{what}: the ranks' global losses "
                                 f"differ: {leg0['losses']} / "
                                 f"{leg1['losses']}")


def tz_untimed(torch, card, work):
    """The work of phases 17-18 that checks and times nothing (`--leg 18u
    OUT WORK`, run beside phase 16a-c): the one-process b256 references
    (saved in WORK for 17b and 18a), then 18b-c's two ranks, with 17a,
    18d and 18e side by side from the start. Its result is also saved
    in WORK as untimed.json."""
    t0 = time.perf_counter()
    images, labels = dp_batch(work)

    def refs_then_model():
        ref_losses = dp_references(torch, work, images, labels)
        say("== phase 18b-c: AlexNet.conf and seq_mnist.conf at mesh = "
            "model:2, each of two ranks sharing the card on every row, "
            f"{DP_STEPS} steps, against one process ==")
        return ref_losses, dp_workers(work, "18w", ("model",),
                                      "tz-result ")

    (ref_losses, model), cli, conv, smoke = side_by_side(
        refs_then_model, lambda: dp_dist_conf(work),
        lambda: tz_mnist_conv(work), lambda: tz_zero_smoke(work))
    out = {"ref_losses": ref_losses, "model": model, "cli": cli,
           "conv": conv, "smoke": smoke,
           "secs": time.perf_counter() - t0}
    with open(os.path.join(work, "untimed.json"), "w") as f:
        json.dump(out, f)
    say(f"phases 17a, 18b-e took {out['secs']:.1f} s")
    return out


def phase_tensor_zero(torch, card, work=None, zero=None):
    """Phase 18 (`chip_smoke.py --leg 18 OUT [WORK]`): 18a AlexNet.conf
    b256 at data:2 under zero_stage 1-3, alone (it times its
    collectives); with WORK the rest - 18b AlexNet.conf and 18c
    seq_mnist.conf at model:2, 18d MNIST_CONV.conf at data:2,model:2
    under zero_stage 3 through the CLI (four ranks) beside the CPU, 18e
    the port's zero_smoke on the card - is what `--leg 18u` left there,
    and alone it runs here first. `zero`: 18a's workers' results when
    they ran already (the whole script's `--leg 1718w`)."""
    import numpy as np
    t18 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if work is None:
            work = stack.enter_context(tempfile.TemporaryDirectory())
            pre = tz_untimed(torch, card, work)
        else:
            with open(os.path.join(work, "untimed.json")) as f:
                pre = json.load(f)
        ref_losses, model = pre["ref_losses"], pre["model"]
        conv, smoke = pre["conv"], pre["smoke"]
        say("== phase 18a: AlexNet.conf at full width, global batch 256 "
            "(128 a rank), mesh = data:2, two ranks sharing the card "
            f"(gloo), {DP_STEPS} steps at zero_stage 2 and 3 (float32) "
            "and 1 and 3 (bfloat16), against one process at b256 ==")
        # 18a times its collectives: alone
        if zero is None:
            zero = dp_workers(work, "18w", ("zero",), "tz-result ")
        tz_held(torch, zero, ref_losses, "18a")
    tz_held(torch, model, ref_losses, "18b")
    for res in model:
        seq = res["seq"]
        want = {n: DP_STEPS * (1 if n in K2 else 0) for n in seq["counts"]}
        if seq["counts"] != want or seq["check_weights"]:
            raise AssertionError(f"18c rank {res['rank']}: launches "
                                 f"{seq['counts']} (want {want}), "
                                 f"check_weights {seq['check_weights']}")
        if not all(np.isfinite(seq["losses"])):
            raise AssertionError(f"18c: non-finite {seq['losses']}")
        if res["tp_calls"]["reduce"] == 0 or res["tp_calls"]["gather"] == 0:
            raise AssertionError(f"18b-c: no model-axis collective ran: "
                                 f"{res['tp_calls']}")
    for res in zero:
        if res["reduce_scatters"] == 0:
            raise AssertionError("18a: no reduce-scatter ran")
    say(f"backend {zero[0]['backend']}; reduce-scatters per rank "
        f"{zero[0]['reduce_scatters']}; collectives staged through pinned "
        f"host memory per rank: {zero[0]['host_staged']} (18a), "
        f"{model[0]['host_staged']} (18b-c)")
    for res in zero:
        for leg in res["alexnet"]:
            b = leg["bytes"]
            say(f"18a rank {res['rank']} {leg['dtype']} stage "
                f"{leg['stage']}: params {b['params'] / 2 ** 20:.1f} MiB, "
                f"gradients {b['grads'] / 2 ** 20:.1f} MiB, accumulator "
                f"{b['accum'] / 2 ** 20:.1f} MiB, updater state "
                f"{b['ustate'] / 2 ** 20:.1f} MiB; "
                + (f"reduce-scatter of {leg['reduce_scatter_mib']:.1f} MiB "
                   f"{leg['reduce_scatter_ms']:.1f} ms, "
                   if "reduce_scatter_ms" in leg else "")
                + f"all-gather of {leg['allgather_mib']:.1f} MiB "
                f"{leg['allgather_ms']:.1f} ms; losses "
                f"{[round(v, 5) for v in leg['losses']]}, step ms "
                f"{[round(v, 1) for v in leg['step_ms']]}"
                + (f", worst update {leg['f32_worst_key']} "
                   f"{leg['f32_worst_update_rel']:.3e} of its norm (bar "
                   f"{UPDATE_BAR})" if leg["dtype"] == "float32" else
                   f", loss vs one process "
                   f"{leg['loss_rel_vs_one_process']:.2e} (bar "
                   f"{DP_BF16_LOSS_BAR})"))
    for res in model:
        for leg in res["alexnet"]:
            say(f"18b rank {res['rank']} {leg['dtype']}: conv/fc weights "
                f"{leg['conv_fc_bytes'] / 2 ** 20:.1f} MiB of "
                f"{leg['conv_fc_whole_bytes'] / 2 ** 20:.1f} MiB whole "
                f"({leg['conv_fc_bytes'] / leg['conv_fc_whole_bytes']:.3f})"
                f", launches {leg['counts']}, losses "
                f"{[round(v, 5) for v in leg['losses']]}, step ms "
                f"{[round(v, 1) for v in leg['step_ms']]} (not alone)"
                + (f", worst update {leg['f32_worst_key']} "
                   f"{leg['f32_worst_update_rel']:.3e} of its norm (bar "
                   f"{UPDATE_BAR})" if leg["dtype"] == "float32" else
                   f", loss vs one process "
                   f"{leg['loss_rel_vs_one_process']:.2e}"))
        seq = res["seq"]
        say(f"18c rank {res['rank']}: {seq['rows']} rows a step, nhead "
            f"{seq['nhead']} (2 heads a rank), launches "
            f"{ {n: c for n, c in seq['counts'].items() if c} } over "
            f"{DP_STEPS} steps (K2 1-1-1 a step), no SDPA and no plain "
            f"version; model-axis collectives {res['tp_calls']}")
    say(f"one process b256: bfloat16 losses "
        f"{[round(v, 5) for v in ref_losses]}")
    say("times are of ranks sharing one card (gloo's host path), not a "
        f"multi-GPU scaling figure; {card}")
    secs = time.perf_counter() - t18
    say(f"phase 18 took {secs:.1f} s (18a; 17a and 18b-e beside phase "
        f"16a-c: {pre['secs']:.1f} s)")
    return {"zero": zero, "model": model, "conv": conv, "smoke": smoke,
            "ref_losses": ref_losses, "secs": secs,
            "untimed_secs": pre["secs"]}


# ---------------------------------------------------------------------------
# phase 19: the seq axis - ring and Ulysses attention, ranks sharing the card
# ---------------------------------------------------------------------------

SEQ_MESH_LINE = "# mesh = data:2,seq:2\n"
# taken out of seq_mnist.conf for 19a, as 18d takes MNIST_CONV.conf's:
# each device draws its masks from its own generator
SEQ_MNIST_DROPOUT = "layer[14->14] = dropout\n  threshold = 0.2\n"
# 19b: the whole sequence; each of two ranks holds half of it
SP_SHAPE = (1, 8, 8192, 128)
SP_BLOCK = (1, 8, 4096, 128)
SP_ITERS = 3
ZERO_SEQ_TEXT = ("composes with 'data'/'model' mesh axes only; axes "
                 "['seq']")


def sp_conf(work: str) -> str:
    """seq_mnist.conf with its own mesh line uncommented and its dropout
    layer taken out, written into work."""
    with open(SEQ_CONF) as f:
        text = f.read()
    if SEQ_MESH_LINE not in text or SEQ_MNIST_DROPOUT not in text:
        raise AssertionError("seq_mnist.conf's mesh line or dropout layer "
                             "moved")
    path = os.path.join(work, "seq_mnist_seq.conf")
    with open(path, "w") as f:
        f.write(text.replace(SEQ_MESH_LINE, SEQ_MESH_LINE[2:])
                .replace(SEQ_MNIST_DROPOUT, ""))
    return path


# 19a's float32 pair and 19c: (label, dev, extra keys), run by the CLI's
# LearnTask one after the other in each of four rank processes
SP_INPROC_JOBS = (("gpu:0", "gpu:0", ("num_round=2", "max_round=2",
                                      "dtype=float32")),
                  ("cpu", "cpu", ("num_round=2", "max_round=2",
                                  "dtype=float32")),
                  # the refusal is the trainer's, whatever the device
                  ("zero2", "cpu", ("num_round=1", "max_round=1",
                                    "zero_stage=2")))


def sp_cli_args(conf: str, dev: str, extra) -> list:
    return [conf, "save_model=1", f"dev={dev}", "param_server=dist",
            "test_on_server=1", "silent=0", *extra]


def leg_sp_cli_worker(torch, card, work):
    """A rank of 19a's float32 pair and of 19c (`chip_smoke.py --leg 19r
    OUT WORK`, under the CXN_* variables of a four-rank job): the CLI's
    LearnTask.run on the conf sp_cli wrote, for each of SP_INPROC_JOBS
    one after the other in this process (one process a rank for all
    three jobs: sixteen interpreters' start-up would crowd the host),
    each in its own directory, its output captured; a job that raises
    is recorded. The result is printed as one `sp-cli-result` line."""
    import io
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.main import LearnTask
    conf = os.path.join(work, "seq_mnist_seq.conf")
    out = {}
    for label, dev, extra in SP_INPROC_JOBS:
        kernels.reset_launches()
        err, std = io.StringIO(), io.StringIO()
        here = os.getcwd()
        os.chdir(os.path.join(work, "seq_" + label.replace(":", "")))
        error = ""
        try:
            with contextlib.redirect_stderr(err), \
                    contextlib.redirect_stdout(std):
                LearnTask().run(sp_cli_args(conf, dev, extra))
        except Exception as e:  # noqa: BLE001 - recorded, judged by sp_cli
            error = f"{type(e).__name__}: {e}"
        finally:
            os.chdir(here)
        out[label] = {"stderr": err.getvalue(), "stdout": std.getvalue(),
                      "error": error}
    sys.stdout.write("sp-cli-result " + json.dumps(out) + "\n")
    sys.stdout.flush()
    return out


def sp_cli(work: str):
    """19a and 19c: seq_mnist.conf at its own mesh = data:2,seq:2
    (dropout taken out), four ranks, 2 rounds, test_on_server = 1: on
    the card as shipped through the CLI (b100, 4 heads, bfloat16; four
    processes under tools/launch_dist: the round lines, finite weights,
    each rank's K2 launches), and, in four worker processes running the
    CLI's LearnTask (leg_sp_cli_worker), on the card and on the CPU in
    float32 - the card's round lines within 0.01 of the CPU's and rank
    0's last checkpoint within rtol 1e-3 / atol 1e-5 of the CPU's (a
    bfloat16 pair cannot be held to that bar: its trajectories part by
    rounding alone, PERF.md §6) - then the same conf at zero_stage =
    2, which every rank must refuse with the JAX trainer's text."""
    import numpy as np
    from cxxnet_tpu_torch.nnet import checkpoint
    conf = sp_conf(work)
    # one thread a rank: eight ranks run beside phase 16a-c
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    dirs = {}
    for label in ("bf16",) + tuple(j[0] for j in SP_INPROC_JOBS):
        d = os.path.join(work, "seq_" + label.replace(":", ""))
        os.makedirs(os.path.join(d, "data"))
        # a weaker class signal than the default: the round lines stay
        # off 0 (a wrong path would move them). 2 steps a round: at eta
        # 0.1 the float32 card / CPU pair parts by rounding, growing with
        # the steps (7.4e-05 max abs after 12, PERF.md §6)
        write_mnist(os.path.join(d, "data"), 200, 35, prefix="train",
                    gain=35.0)
        write_mnist(os.path.join(d, "data"), 500, 36, gain=35.0)
        dirs[label] = d
    t0 = time.perf_counter()
    bf16 = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.launch_dist", "-n",
         "4", "--coordinator", f"127.0.0.1:{free_port()}", "--",
         sys.executable, "-m", "cxxnet_tpu_torch.main",
         *sp_cli_args(conf, "gpu:0", ("num_round=2", "max_round=2"))],
        cwd=dirs["bf16"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = dp_workers(work, "19r", (), "sp-cli-result ", n=4,
                           threads="1")
    finally:
        bf16_out = bf16.communicate(timeout=600)
    secs = time.perf_counter() - t0
    say("== phase 19a: examples/LongSeq/seq_mnist.conf at its own mesh = "
        "data:2,seq:2 (dropout taken out), four ranks, dev = gpu:0 "
        "(gloo): as shipped (b100, 4 heads, bfloat16) through the CLI, and "
        "in float32 against dev = cpu; 19c: the same at zero_stage = 2 ==")
    if bf16.returncode != 0:
        raise AssertionError(f"seq_mnist.conf at data:2,seq:2 (bf16) "
                             f"exited {bf16.returncode}:\n"
                             f"{bf16_out[1][-3000:]}")
    outs = {"bf16": bf16_out}
    for label in ("gpu:0", "cpu"):
        bad = [r[label]["error"] for r in ranks if r[label]["error"]]
        if bad:
            raise AssertionError(f"seq_mnist.conf at data:2,seq:2 "
                                 f"({label}, float32): {bad[0]}\n"
                                 f"{ranks[0][label]['stderr'][-3000:]}")
        outs[label] = ("".join(r[label]["stdout"] for r in ranks),
                       "".join(r[label]["stderr"] for r in ranks))
    for ln in bf16_out[1].splitlines():
        if ln.startswith("param_server=dist"):
            say("  " + ln)
    rounds = {k: dp_rounds(outs[k][1]) for k in ("bf16", "gpu:0", "cpu")}
    if any(len(r) != 2 for r in rounds.values()):
        raise AssertionError(f"expected 2 round lines each: {rounds}")
    worst_err = 0.0
    for lg, lc in zip(rounds["gpu:0"], rounds["cpu"]):
        vg = [float(t.split(":")[1]) for t in lg.split("\t")[1:]]
        vc = [float(t.split(":")[1]) for t in lc.split("\t")[1:]]
        worst_err = max(worst_err, *(abs(a - b) for a, b in zip(vg, vc)))
    blobs = {}
    for k in ("bf16", "gpu:0", "cpu"):
        with open(os.path.join(dirs[k], "models", "0002.model"), "rb") as f:
            blobs[k] = checkpoint.load_model(f)["params"]
    worst, off = 0.0, []
    for lk, dd in blobs["cpu"].items():
        for pn, want in dd.items():
            for k in ("bf16", "gpu:0"):
                got = blobs[k][lk][pn]
                if got.shape != want.shape or not np.isfinite(got).all():
                    raise AssertionError(f"0002.model ({k}) {lk}/{pn}: "
                                         f"shape {got.shape} vs "
                                         f"{want.shape} or non-finite")
            got = blobs["gpu:0"][lk][pn]
            err = float(np.abs(got - want).max())
            worst = max(worst, err)
            if not np.allclose(got, want, rtol=1e-3, atol=1e-5):
                off.append(f"{lk}/{pn} max abs {err:.3e}")
    if off or worst_err > 0.01:
        raise AssertionError(f"19a float32: card {rounds['gpu:0']} vs CPU "
                             f"{rounds['cpu']} (bar 0.01, worst "
                             f"{worst_err:g}); 0002.model outside rtol "
                             f"1e-3 / atol 1e-5: {off}")
    counts = {k: [ast.literal_eval(m) for m in re.findall(
        r"kernel launches (\{.*\})", outs[k][0])] for k in ("bf16", "gpu:0")}
    for k, cs in counts.items():
        if len(cs) != 4 or any(c[n] == 0 for c in cs for n in K2):
            raise AssertionError(f"19a ({k}): K2 launches per rank {cs}")
    refused = sum(ZERO_SEQ_TEXT in r["zero2"]["error"] for r in ranks)
    if refused != 4:
        raise AssertionError(f"19c: zero_stage = 2 on data:2,seq:2 refused "
                             f"with the JAX text by {refused} of 4 ranks: "
                             f"{[r['zero2']['error'] for r in ranks]}")
    k2 = {k: [{n: c[n] for n in K2} for c in cs] for k, cs in counts.items()}
    say(f"as shipped (bfloat16): {rounds['bf16']}, every weight finite, "
        f"K2 launches per rank {k2['bf16']}; float32 card: "
        f"{rounds['gpu:0']}; float32 CPU: {rounds['cpu']}; test_on_server "
        f"= 1 held every round on the four ranks of each; the float32 "
        f"round lines differ by at most {worst_err:g} (bar 0.01); rank "
        f"0's 0002.model card vs CPU: max abs {worst:.3e} (rtol 1e-3, "
        f"atol 1e-5); 19c: all 4 ranks refused zero_stage = 2 with the JAX "
        f"text; the jobs in {secs:.1f} s")
    return {"rounds_bf16": rounds["bf16"], "rounds_card": rounds["gpu:0"],
            "rounds_cpu": rounds["cpu"], "max_abs_checkpoint": worst,
            "max_round_diff": worst_err, "counts": k2["bf16"],
            "counts_f32": k2["gpu:0"], "secs": secs}


def sp_case(torch, mesh, scheme: str, causal: bool, rank: int):
    """One 19b case on this rank: the ring or Ulysses on its half of
    SP_SHAPE (bfloat16) against flash_attention on the whole sequence in
    this process, output and q / k / v gradients under attn_close's
    bfloat16 bar; its launches, a step's time (forward + backward) and
    its exchanges' (the ring's hop of K and V, Ulysses' all-to-all of q,
    k and v), with CUDA events and the host clock."""
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.ops import flash_attention as FA
    from cxxnet_tpu_torch.parallel import distributed, ring
    g = torch.Generator(device="cuda").manual_seed(19)
    whole = [torch.randn(SP_SHAPE, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(4)]
    s = SP_SHAPE[2] // 2
    blk = slice(rank * s, (rank + 1) * s)
    leaves = [t.clone().requires_grad_(True) for t in whole[:3]]
    o_ref = FA.flash_attention(*leaves, causal)
    o_ref.backward(whole[3])
    refs = [o_ref.detach()] + [t.grad for t in leaves]
    mine = [t[:, :, blk].contiguous() for t in whole]

    def step():
        qkv = [t.clone().requires_grad_(True) for t in mine[:3]]
        o = ring.seq_parallel_attention(*qkv, mesh, scheme, causal=causal)
        o.backward(mine[3])
        return [o.detach()] + [t.grad for t in qkv]

    torch.cuda.synchronize()
    k0 = kernels.launches()
    got = step()
    torch.cuda.synchronize()
    k1 = kernels.launches()
    launches = {n: k1[n] - k0[n] for n in K2}
    errs, ok = [], []
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, refs):
        b = b[:, :, blk]
        errs.append(float((a.float() - b.float()).abs().max()))
        ok.append(attn_close(torch, a, b, grad=name != "o"))
    if not all(ok):
        raise AssertionError(f"19b {scheme} causal={causal} rank {rank}: "
                             f"o/dq/dk/dv within the bar {ok}, max abs "
                             f"{errs}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        torch.cuda.synchronize()
        torch.distributed.barrier(mesh.seq_group)
        t0 = time.perf_counter()
        start.record()
        for _ in range(SP_ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(end) / SP_ITERS,
                (time.perf_counter() - t0) * 1e3 / SP_ITERS)

    step_ms, step_host_ms = timed(step)
    peers = mesh.seq_peers
    if scheme == "ring":
        def exchange():
            distributed.ring_hop(mine[1:3], mesh.seq_group,
                                 peers[(rank + 1) % 2],
                                 peers[(rank - 1) % 2]).wait()
    else:
        stacked = torch.stack(mine[:3])

        def exchange():
            ring._to_heads(stacked, mesh.seq_group, 2)
    xchg_ms, xchg_host_ms = timed(exchange)
    return {"scheme": scheme, "causal": causal, "launches": launches,
            "max_abs_err": errs, "step_ms": step_ms,
            "step_host_ms": step_host_ms, "exchange_ms": xchg_ms,
            "exchange_host_ms": xchg_host_ms}


def sp_rank(torch, rank: int, calls):
    """Phase 19b on this rank of a two-rank job over the card (gloo):
    mesh = seq:2, the ring and Ulysses, causal and not (sp_case); then
    K2 alone (flash_attention, forward + backward) on one rank's block.
    `calls` (dp_count_plain's) also counts the plain versions of the
    ring's own route from here on."""
    from cxxnet_tpu_torch.ops import attention as attn_ops
    from cxxnet_tpu_torch.ops import flash_attention as FA
    from cxxnet_tpu_torch.parallel import distributed
    from cxxnet_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    for mod, name in ((attn_ops, "attention_partial"),
                      (FA, "flash_dq_reference"),
                      (FA, "flash_dkv_reference")):
        def counted(*a, __fn=getattr(mod, name), __name=name, **k):
            calls[__name] += 1
            return __fn(*a, **k)
        calls[name] = 0
        setattr(mod, name, counted)
    mesh = build_mesh(MeshSpec(axes=[("seq", 2)]), 1, 2, rank)
    staged = distributed.host_staged[0]
    cases = [sp_case(torch, mesh, scheme, causal, rank)
             for scheme in ("ring", "ulysses") for causal in (False, True)]
    g = torch.Generator(device="cuda").manual_seed(23)
    qkv = [torch.randn(SP_BLOCK, generator=g, device="cuda",
                       dtype=torch.bfloat16).requires_grad_(True)
           for _ in range(3)]
    do = torch.randn(SP_BLOCK, generator=g, device="cuda",
                     dtype=torch.bfloat16)
    alone = {}
    for causal in (False, True):
        def k2():
            torch.autograd.grad(FA.flash_attention(*qkv, causal), qkv, do)
        alone[str(causal)] = time_warm(torch, k2, SP_ITERS)
    return {"rank": rank, "cases": cases, "k2_alone_ms": alone,
            "plain_calls": dict(calls), "backend": distributed.backend(),
            "host_staged": distributed.host_staged[0] - staged}


def leg_sp_worker(torch, card, work):
    """A rank of phase 19b (`chip_smoke.py --leg 19w OUT WORK`, under the
    CXN_* variables phase 19 sets): sp_rank. The result is also printed
    as one `sp-result` line. (In the whole script 19b runs in phase
    18a's two workers, after 18a.)"""
    from cxxnet_tpu_torch.parallel import distributed
    rank = int(os.environ["CXN_WORKER_RANK"])
    calls = dp_count_plain(torch)
    distributed.init_distributed(device=torch.device("cuda:0"),
                                 spec="gpu:0", deadline=120)
    out = sp_rank(torch, rank, calls)
    sys.stdout.write("sp-result " + json.dumps(out) + "\n")
    sys.stdout.flush()
    return out


def phase_seq_parallel(torch, card, work=None, ranks=None):
    """Phase 19 (`chip_smoke.py --leg 19 OUT [WORK]`): 19b alone (it
    times its exchanges) in two workers of its own, or its `ranks`'
    results when phase 18a's workers ran it; with WORK, 19a / 19c are
    what `--leg 19u` left there (run beside phase 16a-c), and alone they
    run here first."""
    t19 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if work is None:
            work = stack.enter_context(tempfile.TemporaryDirectory())
            cli = sp_untimed(torch, card, work)
        else:
            with open(os.path.join(work, "sp_untimed.json")) as f:
                cli = json.load(f)
        say(f"== phase 19b: ring and Ulysses attention at mesh = seq:2, two "
            f"ranks sharing the card (gloo), {SP_SHAPE} bfloat16 (each rank "
            f"{SP_BLOCK}), causal and not, against flash_attention on the "
            "whole sequence in each rank's process ==")
        if ranks is None:
            ranks = dp_workers(work, "19w", (), "sp-result ")
    for res in ranks:
        if any(res["plain_calls"].values()):
            raise AssertionError(f"19b rank {res['rank']}: plain versions "
                                 f"or SDPA ran: {res['plain_calls']}")
        if res["backend"] != "gloo" or res["host_staged"] == 0:
            raise AssertionError(f"19b rank {res['rank']}: backend "
                                 f"{res['backend']}, staged "
                                 f"{res['host_staged']}")
        for c in res["cases"]:
            n = (1 if c["scheme"] == "ulysses"
                 else 1 if (c["causal"] and res["rank"] == 0) else 2)
            if c["launches"] != {k: n for k in K2}:
                raise AssertionError(f"19b rank {res['rank']} {c['scheme']}"
                                     f" causal={c['causal']}: launches "
                                     f"{c['launches']}, want {n} each")
            say(f"19b rank {res['rank']} {c['scheme']} causal="
                f"{int(c['causal'])}: launches {c['launches']}; max abs "
                f"o/dq/dk/dv {[f'{e:.3e}' for e in c['max_abs_err']]} "
                f"(attn_close's bfloat16 bar: 1e-2 |ref| + 1e-2 max|ref| + "
                f"1e-5); a step (forward + backward) {c['step_ms']:.3f} ms "
                f"by CUDA events, {c['step_host_ms']:.3f} ms by the host "
                f"clock; its exchange ({'the hop of K and V' if c['scheme'] == 'ring' else 'the all-to-all of q, k, v'}, "
                f"staged through pinned host memory) "
                f"{c['exchange_ms']:.3f} / {c['exchange_host_ms']:.3f} ms")
        say(f"19b rank {res['rank']}: K2 alone (flash_attention forward + "
            f"backward) at {SP_BLOCK} bfloat16: "
            f"{res['k2_alone_ms']['False']:.3f} ms, causal "
            f"{res['k2_alone_ms']['True']:.3f} ms (CUDA events, L2 warm)")
    say("times are of ranks sharing one card (gloo's host path), not a "
        f"multi-GPU scaling figure; {card}")
    secs = time.perf_counter() - t19
    say(f"phase 19 took {secs:.1f} s (19b; 19a and 19c beside phase "
        f"16a-c: {cli['secs']:.1f} s)")
    return {"cli": cli, "ranks": ranks, "secs": secs}


def sp_untimed(torch, card, work):
    """The work of phase 19 that checks and times nothing (`--leg 19u OUT
    WORK`, beside phase 16a-c with 18u): 19a and 19c (sp_cli). Its
    result is also saved in WORK as sp_untimed.json."""
    out = sp_cli(work)
    with open(os.path.join(work, "sp_untimed.json"), "w") as f:
        json.dump(out, f)
    return out


LEGS = {"10g": leg_image_timing, "11a": phase_googlenet_lrn,
        "11b": phase_googlenet_step, "11d": phase_stack_moe,
        "12": phase_front, "13": phase_surface, "14": phase_native,
        "14u": native_checks,
        "15": phase_dispatch, "16": phase_analysis,
        "17": phase_data_parallel, "17w": leg_dp_worker,
        "18": phase_tensor_zero, "18u": tz_untimed, "18w": leg_tz_worker,
        "1718w": leg_all_worker, "19r": leg_sp_cli_worker,
        "19": phase_seq_parallel, "19u": sp_untimed, "19w": leg_sp_worker}
LEG_LOST = 75  # a leg's exit code when its profiler lost the kernel events


def run_leg(torch, name: str, *args: str):
    """Phase `name` in a fresh python process (this script with --leg,
    then `args`), its lines printed as they come; returns its result. A
    leg whose trace lost the card's kernel events runs once more in
    another fresh process; any other failure raises."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "result.json")
        for attempt in (1, 2):
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--leg", name, out, *args],
                                timeout=900).returncode
            if rc == 0:
                with open(out) as f:
                    return json.load(f)
            if rc != LEG_LOST or attempt == 2:
                raise AssertionError(f"phase {name} failed in its own "
                                     f"process (exit code {rc})")
            say(f"phase {name}: the profiler lost the card's kernel events; "
                "once more in a fresh process")


def leg_main(name: str, out: str, args) -> int:
    """The body of `chip_smoke.py --leg NAME OUT [ARGS]`: run one leg of
    LEGS, write its result to OUT as JSON."""
    import torch
    sys.path.insert(0, REPO)
    try:
        result = LEGS[name](torch, card_line(), *args)
    except ProfilerLost as e:
        sys.stderr.write(f"chip_smoke: phase {name}: {e}\n")
        return LEG_LOST
    with open(out, "w") as f:
        json.dump(result, f, default=lambda v: v.item())  # numpy scalars
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not installed\n")
        return 1
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device - this script needs "
                         "one NVIDIA card\n")
        return 1
    if not os.path.isdir(os.path.join(REPO, "cxxnet_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from a checkout of the repo "
                         "(cxxnet_tpu_torch/ not found beside it)\n")
        return 1
    sys.path.insert(0, REPO)
    from cxxnet_tpu_torch import kernels
    t_main = time.perf_counter()

    say("== phase 1: device ==")
    card = card_line()
    say(card)
    kind = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {kind}; device count {torch.cuda.device_count()}")
    say(f"decoder facts (looked for, nothing built): {decoder_facts()}")

    say("== phase 2: build ==")
    t0 = time.perf_counter()
    built = kernels.build_all()
    say(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in built.items():
        say(f"{name}: {secs:.2f} s")
        for ln in log.splitlines():
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln:
                say("  " + ln.strip())
    say_tc_instances(built)
    say_lrn_instances(built)
    say_lrn_plans(torch)

    max_err, main_rows = phase_kernels(torch)
    bwd_err, bwd_rows = phase_kernels_bwd(torch)
    g_err, g_list = run_leg(torch, "11a")
    g_rows = {(n, tuple(sh), dt): t for n, sh, dt, t in g_list}
    attn_err, attn_rows = phase_attention_kernels(torch, card)
    launches, float_served = phase_serving(torch, card)
    train_counts = phase_training(torch, card)
    seq_counts, seq_step_ms, seq_tr = phase_seq_training(torch, card)
    seq_serve_launches, seq_batches = phase_seq_serving(torch, card, seq_tr)
    del seq_tr
    t9 = time.perf_counter()
    k3_rows = phase_int8_kernel(torch, card)
    int8_tr, int8_reqs, int8_served = phase_int8_serving(torch, card,
                                                         float_served)
    phase_int8_sites(torch, card, int8_tr, int8_reqs)
    del int8_tr
    torch.cuda.empty_cache()
    phase_int8_mlp(torch, card)
    phase_int8_cli()
    say(f"phase 9 took {time.perf_counter() - t9:.1f} s")
    t11 = time.perf_counter()
    g_step = run_leg(torch, "11b")
    moe = run_leg(torch, "11d")
    say(f"phase 11b and 11d on the card took "
        f"{time.perf_counter() - t11:.1f} s")
    # the parts of 13-15 that check and time nothing run beside phase
    # 10's CLI runs; the legs then skip them
    fmt = image_format_used()[0]
    tz_work = tempfile.mkdtemp(prefix="chip_smoke_tz_")
    try:
        (cli_counts, g_cli, moe["cli_counts"], beside), timing, \
            (surface, nat, disp) = phase_image_pipeline(
                torch, card, (lambda d: phase_cli(),
                              lambda d: phase_cli_train(),
                              lambda d: phase_seq_cli(),
                              lambda d: surface_cli_tails(),
                              lambda d: run_leg(torch, "14u"),
                              lambda d: dispatch_seq_cli(torch, card),
                              dispatch_profile_cli),
                lambda d: (run_leg(torch, "13", d, "0"),
                           run_leg(torch, "14", d, fmt, "0"),
                           run_leg(torch, "15", d, "0")))
        surface["cli"] = beside[3]
        nat.update(beside[4])
        disp["seq_cli"], disp["profile_cli"] = beside[5], beside[6]
        native_cli(cli_counts)
        front = run_leg(torch, "12")
        front_launches = (front["in_process"]["lrn_fwd"]
                          + front["http"]["lrn_fwd"])
        front_batches = (front["in_process"]["batches"]
                         + front["http"]["batches"])
        # phases 17-19's untimed work (--leg 18u, --leg 19u) runs beside
        # 16a-c, which checks and times nothing either; 17b, 18a and 19b
        # (timed) run alone after, over what they left, from this process
        # (their ranks are workers of their own; 19b runs in 18a's two)
        analysis = phase_analysis(
            torch, card, beside=lambda: side_by_side(
                lambda: run_leg(torch, "18u", tz_work),
                lambda: run_leg(torch, "19u", tz_work)))

        def plain(result):
            return json.loads(json.dumps(result, default=lambda v: v.item()))
        say("== phases 17b-c, 18a and 19b: one pair of workers sharing the "
            "card (gloo), the phases one after the other ==")
        both = dp_workers(tz_work, "1718w", (), "all-result ")
        dp = plain(phase_data_parallel(torch, card, tz_work,
                                       [b["dp"] for b in both]))
        tz = plain(phase_tensor_zero(torch, card, tz_work,
                                     [b["tz"] for b in both]))
        sp = phase_seq_parallel(torch, card, tz_work,
                                [b["tz"]["sp"] for b in both])
    finally:
        shutil.rmtree(tz_work, ignore_errors=True)

    # the kernels line: the LRN's two launches of one served AlexNet
    # batch (b64, bfloat16), warm L2, summed - the main path's unit
    bf = [main_rows[(s, torch.bfloat16)]
          for s in ((64, 96, 27, 27), (64, 256, 13, 13))]

    def both(key, rows=bf):
        """The rows' sum (None where a row was not measured)."""
        vals = [r[key] for r in rows]
        return None if None in vals else round(sum(vals), 6)

    # K1-bwd: its two launches of one AlexNet training step (b256,
    # bfloat16), warm L2, summed
    bb = [bwd_rows[(s, torch.bfloat16)] for s in TRAIN_LRN_SHAPES]
    tf = [main_rows[(s, torch.bfloat16)] for s in TRAIN_LRN_SHAPES]

    def googlenet(name):
        """K1's two launches of a GoogLeNet b256 bfloat16 step (11a)."""
        rows = [g_rows[(name, sh, "bfloat16")]
                for sh in GOOGLENET_B256_LRN]
        return {
            "googlenet_unit": f"both {name} launches of one GoogLeNet.conf "
                              "b256 bfloat16 step, (256,64,56,56) + "
                              "(256,192,56,56), L2 warm (phase 11a)",
            "googlenet_max_abs_err": g_err[name],
            "googlenet_ms": both("kernel", rows),
            "googlenet_device_ms": both("kernel_device", rows),
            "googlenet_plain_ms": both("plain", rows),
            "googlenet_bound_ms": both("bound", rows),
            "googlenet_library_ms": both("library", rows),
            "googlenet_launches": g_step["counts"][name],
            "googlenet_launches_unit": "GoogLeNet.conf b256 bfloat16, 7 "
                                       "steps (phase 11b)",
            "googlenet_cli_launches": g_cli[name],
        }

    def surface_launches(name):
        """K1 on phase 13's paths: task = extract, wrapper.train and the
        C ABI."""
        return {
            "surface_extract_launches": surface["extract"]["launches"][name],
            "surface_wrapper_launches": surface["wrapper"]["launches"][name],
            "surface_capi_launches": surface["capi"]["launches"][name],
            "surface_unit": "AlexNet.conf b256 bfloat16 (phase 13): task = "
                            "extract of 512 rows (2 batches); "
                            "wrapper.train of 1,024 images, 2 rounds (8 "
                            "steps); the C driver's 4 CXNNetUpdateBatch "
                            "steps and 5 forwards",
        }

    def dispatch(name):
        """Phase 15: K1 under steps_per_dispatch = 4 and remat = 1, K2 in
        seq_mnist.conf's fused CLI run."""
        if name in K2:
            return {"dispatch_cli_launches": disp["seq_cli"]["launches"][name],
                    "dispatch_unit": "seq_mnist.conf through the CLI at "
                                     "steps_per_dispatch = 4, 2 rounds of "
                                     "600 images (phase 15b)"}
        out = {"dispatch_launches": disp["alexnet"]["k4"]["launches"][name],
               "dispatch_unit": "AlexNet.conf b256 bfloat16, 8 microsteps "
                                "in 2 chunks of 4 (phase 15a)",
               "remat_launches": disp["remat"]["remat1"]["launches"][name],
               "remat_unit": "AlexNet.conf b256 bfloat16 under remat = 1, "
                             "2 steps (phase 15c)"}
        return out

    def data_parallel(name):
        """Phase 17: the launches on each rank of the two-rank runs
        sharing the card (the JAX package's sharded entry points are the
        same kernels on each rank's rows)."""
        if name in K2:
            return {"replaces_sharded": "cxxnet_tpu/ops/pallas_attention.py"
                                        ":382 (flash_attention_sharded): "
                                        "flash_attention on each rank's "
                                        "rows",
                    "dp_launches": [r["seq"]["counts"][name]
                                    for r in dp["ranks"]],
                    "dp_unit": "seq_mnist.conf b100 bfloat16 as two ranks "
                               f"sharing the card (50 rows a rank), "
                               f"{DP_STEPS} steps, per rank (phase 17c)"}
        return {"replaces_sharded": "cxxnet_tpu/ops/pallas_lrn.py:154 "
                                    "(lrn_pallas_sharded): lrn on each "
                                    "rank's rows",
                "dp_launches": [r["alexnet"][-1]["counts"][name]
                                for r in dp["ranks"]],
                "dp_unit": "AlexNet.conf global b256 bfloat16 as two ranks "
                           f"sharing the card (128 rows a rank), {DP_STEPS} "
                           f"steps at update_on_server = 1, per rank (phase "
                           f"17b)"}

    def tensor_zero(name):
        """Phase 18: the launches on each rank under the model axis (K1
        on the gathered channels, K2 on 2 of 4 heads) and under
        zero_stage = 3."""
        if name in K2:
            return {"tp_launches": [r["seq"]["counts"][name]
                                    for r in tz["model"]],
                    "tp_unit": "seq_mnist.conf b100 bfloat16 at mesh = "
                               "model:2, every row on each of two ranks "
                               "sharing the card, 2 of its 4 heads a rank, "
                               f"{DP_STEPS} steps, per rank (phase 18c)"}
        return {"tp_launches": [r["alexnet"][-1]["counts"][name]
                                for r in tz["model"]],
                "tp_unit": "AlexNet.conf b256 bfloat16 at mesh = model:2, "
                           "every row on each of two ranks sharing the "
                           "card, on the gathered channels, "
                           f"{DP_STEPS} steps, per rank (phase 18b)",
                "zero_launches": [r["alexnet"][-1]["counts"][name]
                                  for r in tz["zero"]],
                "zero_unit": "AlexNet.conf global b256 bfloat16 at mesh = "
                             "data:2, zero_stage = 3, 128 rows a rank, "
                             f"{DP_STEPS} steps, per rank (phase 18a)"}

    def seq_parallel(name):
        """Phase 19: K2 on the seq axis - each rank's launches in 19a's
        CLI job and in one 19b call of each scheme."""
        cases = {(c["scheme"], c["causal"]): c["launches"][name]
                 for c in sp["ranks"][0]["cases"]}
        cases1 = {(c["scheme"], c["causal"]): c["launches"][name]
                  for c in sp["ranks"][1]["cases"]}
        return {"seq_launches": [c[name] for c in sp["cli"]["counts"]],
                "seq_unit": "seq_mnist.conf (no dropout, bfloat16 as "
                            "shipped) at its own mesh = data:2,seq:2 "
                            "through the CLI, four ranks sharing the card, "
                            "2 rounds of 200 images and 500 test images, "
                            "per rank (phase 19a)",
                "seq_ring_launches": [cases[("ring", False)],
                                      cases1[("ring", False)]],
                "seq_ring_causal_launches": [cases[("ring", True)],
                                             cases1[("ring", True)]],
                "seq_ulysses_launches": [cases[("ulysses", False)],
                                         cases1[("ulysses", False)]],
                "seq_call_unit": f"one forward + backward at {SP_SHAPE} "
                                 "bfloat16 over seq:2, per rank (phase "
                                 "19b)"}

    def stack_moe(name):
        """K2 on stack_moe.conf's path (11d)."""
        out = {"stack_moe_replaces": "cxxnet_tpu/layers/transformer_stack"
                                     ".py:157 (XLA blockwise_attention, "
                                     "no Pallas kernel)",
               "stack_moe_launches": moe["step_counts"][name],
               "stack_moe_launches_unit": "stack_moe.conf b100 bfloat16, "
                                          "12 steps, 4 blocks (phase 11d)",
               "stack_moe_cli_launches": moe["cli_counts"][name]}
        if name == "attn_fwd":
            out.update({"stack_moe_serve_launches": moe["serve_launches"],
                        "stack_moe_serve_batches": moe["serve_batches"]})
        return out
    say(card)
    say(json.dumps({"kernels": [{
        "name": "lrn_fwd",
        "route": "cuda",
        "source": "cxxnet_tpu_torch/csrc/lrn_fwd.cu",
        "replaces": "cxxnet_tpu/ops/pallas_lrn.py:61",
        "replaces_fn": "_fwd_kernel",
        "unit": "both LRN launches of one AlexNet batch of 64, bfloat16, "
                "(64,96,27,27) + (64,256,13,13), L2 warm",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": both("kernel"),
        "kernel_ms": both("kernel"),
        "kernel_cold_ms": both("kernel_cold"),
        "plain_ms": both("plain"),
        "bound_ms": both("bound"),
        "bound_by": bf[0]["by"],
        "library_ms": both("library"),
        "library_cold_ms": both("library_cold"),
        "kernel_device_ms": both("kernel_device"),
        "train_launches": train_counts["lrn_fwd"],
        "train_unit": "both LRN launches of one AlexNet b256 bfloat16 "
                      "training step, L2 warm",
        "train_ms": both("kernel", tf),
        "train_cold_ms": both("kernel_cold", tf),
        "train_device_ms": both("kernel_device", tf),
        "train_plain_ms": both("plain", tf),
        "train_bound_ms": both("bound", tf),
        "train_library_ms": both("library", tf),
        "imgbin_cli_launches": cli_counts["lrn_fwd"],
        "imgbin_cli_unit": "AlexNet.conf task = train through the CLI on "
                           "imgbin data, 2 rounds (phase 10c)",
        "front_launches": front_launches,
        "front_batches": front_batches,
        "front_unit": "AlexNet.conf through the serving front (phase 12): "
                      "two in-process bursts of phase 4's requests and 24 "
                      "/predict requests, 2 a batch",
        **surface_launches("lrn_fwd"),
        **googlenet("lrn_fwd"),
        **dispatch("lrn_fwd"),
        **data_parallel("lrn_fwd"),
        **tensor_zero("lrn_fwd"),
    }, {
        "name": "lrn_bwd",
        "route": "cuda",
        "source": "cxxnet_tpu_torch/csrc/lrn_bwd.cu",
        "replaces": "cxxnet_tpu/ops/pallas_lrn.py:70",
        "replaces_fn": "_bwd_kernel",
        "unit": "both LRN backward launches of one AlexNet b256 bfloat16 "
                "step, (256,96,27,27) + (256,256,13,13), L2 warm",
        "launches": train_counts["lrn_bwd"],
        "max_abs_err": bwd_err,
        "ms": both("kernel", bb),
        "kernel_ms": both("kernel", bb),
        "kernel_cold_ms": both("kernel_cold", bb),
        "kernel_device_ms": both("kernel_device", bb),
        "plain_ms": both("plain", bb),
        "bound_ms": both("bound", bb),
        "bound_by": bb[0]["by"],
        "library_ms": both("library", bb),
        "library_cold_ms": both("library_cold", bb),
        "imgbin_cli_launches": cli_counts["lrn_bwd"],
        **surface_launches("lrn_bwd"),
        **googlenet("lrn_bwd"),
        **dispatch("lrn_bwd"),
        **data_parallel("lrn_bwd"),
        **tensor_zero("lrn_bwd"),
    }] + [dict(attn_entry(n, attn_rows, attn_err[n], seq_counts[n]),
               **stack_moe(n), **dispatch(n), **data_parallel(n),
               **tensor_zero(n), **seq_parallel(n))
          for n in K2] + [dict(int8_entry(k3_rows, int8_served, 0),
                               front_launches=front["int8"]["int8_mm"],
                               front_batches=front["int8"]["batches"],
                               front_unit="4 /predict requests to the int8 "
                                          "graph (phase 12f), 11 a batch"),
                          native_entry(nat, cli_counts)]}))
    settings = ("streamed (prefetch_stage = 0)", "prefetch_stage = 1",
                "prefetch_stage = 1 + device_augment = 1")
    say("phase 14 against 10g (images/s, idle share, the iterator's own "
        "rate; PIL then nvJPEG) " + json.dumps({
            label: {"pil": {k: timing[label][k] for k in
                            ("images_s", "idle", "iterator_images_s")},
                    "nvjpeg": {k: nat["settings"]["use_native = 1, "
                                                  + label][k]
                               for k in ("images_s", "idle",
                                         "iterator_images_s")}}
            for label in settings}, default=float))
    say("phase 15 summary " + json.dumps({
        "alexnet": {k: {f: v[f] for f in ("step_ms", "idle",
                                          "guard_readbacks")}
                    for k, v in disp["alexnet"].items()},
        "remat_peak_mib": {k: disp["remat"][k]["peak_bytes"] / 2 ** 20
                           for k in ("remat0", "remat1")},
        "tuning": disp["tuning"]["knobs"]}, default=float))
    say("phase 13 summary " + json.dumps({
        "extract_rows_s": surface["extract"]["rows_s"],
        "wrapper": {k: v for k, v in surface["wrapper"].items()
                    if k != "launches"},
        "capi_images_s": surface["capi"]["images_s"]}))
    say("phase 16 summary " + json.dumps({
        "kernel_routing": analysis["kernel_routing"],
        "audit_checks": analysis["audit_checks"],
        "lock_checks": analysis["lock_checks"],
        "secs": analysis["secs"]}))
    say("phase 17 summary " + json.dumps({
        "cli": dp["cli"], "ref_losses": dp["ref_losses"],
        "secs": dp["secs"],
        "alexnet": [{k: leg[k] for k in ("dtype", "update_on_server",
                                         "losses", "step_ms",
                                         "allreduce_ms", "allgather_ms",
                                         "ustate_bytes") if k in leg}
                    for leg in dp["ranks"][0]["alexnet"]]}))
    say("phase 18 summary " + json.dumps({
        "secs": tz["secs"], "ref_losses": tz["ref_losses"],
        "conv": tz["conv"], "zero_smoke": tz["smoke"]["summary"],
        "zero": [{k: leg[k] for k in ("dtype", "stage", "losses", "bytes",
                                      "reduce_scatter_ms", "allgather_ms")
                  if k in leg} for leg in tz["zero"][0]["alexnet"]],
        "model": [{k: leg[k] for k in ("dtype", "losses", "conv_fc_bytes",
                                       "conv_fc_whole_bytes")}
                  for leg in tz["model"][0]["alexnet"]]}))
    say("phase 19 summary " + json.dumps({
        "secs": sp["secs"], "untimed_secs": sp["cli"]["secs"],
        "cli": {k: sp["cli"][k] for k in ("rounds_bf16", "rounds_card",
                                          "rounds_cpu", "max_abs_checkpoint",
                                          "max_round_diff")},
        "ranks": [{"k2_alone_ms": r["k2_alone_ms"],
                   "cases": [{k: c[k] for k in (
                       "scheme", "causal", "step_ms", "step_host_ms",
                       "exchange_ms", "exchange_host_ms", "max_abs_err")}
                       for c in r["cases"]]} for r in sp["ranks"]]}))
    say(f"seq_mnist: {seq_serve_launches} attn_fwd launches over "
        f"{seq_batches} served batches; training step {seq_step_ms:.3f} ms")
    say("phase 11 summary " + json.dumps({
        "googlenet_step": {k: v for k, v in g_step.items()},
        "stack_moe": {"step_ms": moe["step_ms"],
                      "rows_s": moe["serve"]["rows_s"],
                      "latency_p50_ms": moe["serve"]["latency_p50_ms"],
                      "latency_p99_ms": moe["serve"]["latency_p99_ms"],
                      "queue_p50_ms": moe["serve"]["queue_p50_ms"],
                      "queue_p99_ms": moe["serve"]["queue_p99_ms"],
                      "device_p50_ms": moe["serve"]["device_p50_ms"],
                      "device_p99_ms": moe["serve"]["device_p99_ms"]}}))
    say(f"chip_smoke took {time.perf_counter() - t_main:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--leg":
        sys.exit(leg_main(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
