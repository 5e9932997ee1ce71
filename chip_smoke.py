#!/usr/bin/env python3
"""Drive cxxnet_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc). Phases, each of which raises on failure:

1. device: the card's name and power limit, and which of jpeglib.h,
   png.h, nvjpeg.h, libnvjpeg and g++ the machine has (looked for,
   nothing built: what a native or nvJPEG decoder could build on);
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
   each, then kaggle_bowl/pred.conf (task = pred_raw) on bowl's model;
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
   SIGTERM: exit 0 and every admitted row in the output.

It prints one JSON line with every kernel's numbers, then, as the last
line, {"ok": true, "device": {...}}. With no card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import ast
import gzip
import json
import os
import re
import struct
import subprocess
import sys
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


def say(line: str) -> None:
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


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
        runs = (("pred", ["pass_calibration_batches=2"],
                 "graph_passes: calibrated on 2 batch(es) from the pred "
                 "iterator"),
                ("serve", ["pass_calibration_batches=2", "serve_rows=0"],
                 "graph_passes: calibrated on 2 batch(es) from the pred "
                 "iterator"),
                ("pred1", ["pass_calibration_iter=pred"],
                 "graph_passes: calibrated on 1 batch(es) from the pred "
                 "iterator"))
        for name, extra, line in runs:
            out = os.path.join(d, f"{name}.txt")
            task = "serve" if name == "serve" else "pred"
            proc = run_cli(common + [f"task={task}", f"pred={out}"] + extra)
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
                say("task=serve child: " + next(
                    ln for ln in proc.stdout.splitlines()
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
                    classes: int, seed: int, fmt: str) -> None:
    """n size x size RGB images under d/sub/ with a class signal (a
    bright square whose place and channel follow the label, over
    noise), their .lst at d/lst.lst, packed into d/lst.bin by the port's
    im2bin."""
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
        if fmt == "JPEG":
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
    m = re.search(r"kernel launches (\{.*\})", stdout)
    return ast.literal_eval(m.group(1)) if m else {}


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


def make_iter(conf, cwd, extra=()):
    """The iterator the CLI builds from a (global pairs, block) conf run
    in `cwd`: the block's chain, the global pairs set on it (batch_size,
    input_shape, ...), relative file paths resolved from `cwd`."""
    from cxxnet_tpu_torch.io import create_iterator
    defcfg, block = conf
    paths = ("image_list", "image_bin", "image_root", "image_mean")

    def fix(pairs):
        return [(k, os.path.join(cwd, v) if k in paths else v)
                for k, v in pairs]
    it = create_iterator(fix(block[:-1]) + list(extra) + block[-1:])
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


def phase_image_cli(d: str, fmt: str):
    """(c) and (d): AlexNet.conf, ResNet18.conf and bowl.conf through the
    CLI on their own imgbin data, each in a directory of its own whose
    ./data/ links to the shared set (the confs' relative paths resolve
    unedited). Returns AlexNet's kernel launches."""
    import numpy as np
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

    say("== phase 10d: ResNet18.conf and kaggle_bowl/bowl.conf + pred.conf "
        "through the CLI ==")
    res = os.path.join(d, "resnet18")
    os.makedirs(res)
    os.symlink(os.path.join(d, "shared", "data"), os.path.join(res, "data"))
    cli_train_checked(os.path.join(IMAGENET_CONFS, "ResNet18.conf"), res, 2,
                      "ResNet18.conf")
    bowl = os.path.join(d, "bowl")
    write_image_set(bowl, "img_tr", "tr", 256, 64, 12, 31, fmt)
    write_image_set(bowl, "img_va", "va", 128, 64, 12, 32, fmt)
    write_image_set(bowl, "img_te", "te", 128, 64, 12, 33, fmt)
    cli_train_checked(os.path.join(BOWL_CONFS, "bowl.conf"), bowl, 2,
                      "bowl.conf")
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
    return counts


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
    """2 warm-up and 10 timed steps of tr.update over itr's batches (the
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
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 100.0
        profiled = profile_steps(torch, step, 3, strict=True)
    finally:
        if prefetch:
            it.close()
    rows, groups, busy_ms, window_ms = profiled
    idle = (1 - busy_ms / window_ms) if window_ms else float("nan")
    return step_ms, idle


def iterator_rate(itr) -> float:
    """Images/s of one pass of the iterator alone (decode, augment,
    batch; no trainer)."""
    itr.before_first()
    n, t0 = 0, time.perf_counter()
    while itr.next():
        n += itr.value().data.shape[0] - itr.value().num_batch_padd
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
        f"clock over 10 steps, CUDA-synchronised); device idle share "
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
        extra = [("device_augment", "1")] if daug else []
        itr = make_iter(block, tdir, extra)
        b = pull(itr, 1)[0]
        stop_iter(itr)
        st = staging_ms(torch, tr, lambda: tr.stage_batch(b), 3)
        rate = iterator_rate(itr)
        step_ms, idle = timed_setting(torch, tr, itr, prefetch)
        stop_iter(itr)
        say_setting(results, label, step_ms, idle, device_ms, card, rate, st,
                    "uint8" if daug else "bfloat16")
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


def phase_image_pipeline(torch, card, then=None):
    """Phase 10: the image data pipeline on the card; then `then(d)`
    (phase 11's GoogLeNet legs) while phase 10's imgbin set under `d`
    still exists. Returns (AlexNet's CLI launches, 10g's timing,
    then's result)."""
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
        counts = phase_image_cli(d, fmt)
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

    def run(self, graph, cparams, data):
        out = graph.run(cparams, self.trainer.stage_infer_rows(data))
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
    # them waits past its deadline in the queue
    fault.inject("serve_dispatch_delay", "delay", "0.5", at=1)
    fault.inject("serve_dispatch_delay", "delay", "0.5", at=2)
    blockers = [srv.submit(reqs[0]) for _ in range(2)]
    if not wait_for(lambda: srv._queued_rows == 0, 10.0):
        raise AssertionError("the blockers never left the queue")
    time.sleep(0.05)
    code, _h, body = post_json(port, json.dumps({
        "data": reqs[1].reshape(1, -1).tolist(),
        "deadline_ms": 50}).encode())
    for b in blockers:
        b.result(timeout=60)
    fault.clear()
    if code != 504:
        raise AssertionError(f"a 50 ms deadline behind a 0.5 s dispatch "
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


# phase 11's profiled legs, each run in a fresh python process: in a
# long-lived process torch.profiler can lose the card's kernel events
# (PERF.md §7), and these legs must report device times
def leg_image_timing(torch, card, d, fmt):
    """Phase 10g as a leg: the timing set under `d` (phase 10's temporary
    directory, which outlives the leg's process), images in `fmt`."""
    return phase_image_timing(torch, d, fmt, card)


LEGS = {"10g": leg_image_timing, "11a": phase_googlenet_lrn,
        "11b": phase_googlenet_step, "11d": phase_stack_moe,
        "12": phase_front}
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
    phase_cli()
    train_counts = phase_training(torch, card)
    phase_cli_train()
    seq_counts, seq_step_ms, seq_tr = phase_seq_training(torch, card)
    seq_serve_launches, seq_batches = phase_seq_serving(torch, card, seq_tr)
    del seq_tr
    phase_seq_cli()
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
    cli_counts, _timing, g_cli = phase_image_pipeline(
        torch, card, phase_googlenet_cli)
    t11 = time.perf_counter()
    moe["cli_counts"] = phase_stack_moe_cli()
    say(f"phase 11c-d through the CLI took {time.perf_counter() - t11:.1f}"
        " s")
    front = run_leg(torch, "12")
    front_launches = (front["in_process"]["lrn_fwd"]
                      + front["http"]["lrn_fwd"])
    front_batches = (front["in_process"]["batches"]
                     + front["http"]["batches"])

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
        **googlenet("lrn_fwd"),
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
        **googlenet("lrn_bwd"),
    }] + [dict(attn_entry(n, attn_rows, attn_err[n], seq_counts[n]),
               **stack_moe(n))
          for n in K2] + [dict(int8_entry(k3_rows, int8_served, 0),
                               front_launches=front["int8"]["int8_mm"],
                               front_batches=front["int8"]["batches"],
                               front_unit="4 /predict requests to the int8 "
                                          "graph (phase 12f), 11 a batch")]}))
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
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--leg":
        sys.exit(leg_main(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
