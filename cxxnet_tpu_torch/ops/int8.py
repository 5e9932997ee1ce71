"""Int8 post-training-quantized inference: the scale arithmetic, the
CUDA kernel K3 and its plain version (counterpart of
cxxnet_tpu/ops/int8.py).

The quantize_int8 graph pass (nnet/passes.py) stamps eligible conv/fullc
layers with a per-channel symmetric weight scale and a per-tensor
activation scale, both frozen at calibration. This module is the
execution vocabulary of that pass, with the JAX package's rounding:

- `per_channel_scale`: host-side numpy, float32 - absmax per output
  channel, floored at 1e-8, divided by 127 in float32;
- `quantize_weight`: multiply by the float32 reciprocal of the scale,
  round half to even, clip to [-127, 127], int8;
- `quantize_act`: DIVIDE by the per-tensor scale (not multiply by its
  reciprocal - the two can differ by an ulp), round, clip, int8;
- `dequantize`: `s = act_scale * w_scale` formed first in float32, then
  `acc.float() * s`.

`int8_matmul` is `xq (m, k) . wq (n, k)^T -> (m, n)` int32, exact: on a
CUDA tensor it launches K3 (`csrc/int8_mm.cu`, the port of the TPU
kernel `_mm_kernel`) or raises; on a CPU tensor it runs the plain
version `int8_matmul_reference`, an int32 product. The JAX package
took its Pallas kernel only where Mosaic's tiling allowed (k % 128,
m % 32, n % 128, one device) and XLA's `dot_general` otherwise - both
compute the same int32; K3 takes every shape.

`int8_conv2d` (a `lax.conv` with int32 accumulation in the JAX package,
no Pallas kernel) is routed here as im2col then one int8 GEMM per group
through `int8_matmul` - K3 on the card. The unfold runs in a float type
(float16 on the card, float32 on the CPU), where every int8 value is
exact, and casts back to int8. A float convolution over the int-valued
tensors would not do: conv2's k = 1200 products can exceed 2^24, where
float32 accumulation rounds. `torch._int_mm` is no route either: it
requires k and n to be multiples of 8 (AlexNet conv1 has k = 363), and
a library GEMM is no port of K3.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cxxnet_tpu_torch import kernels

# an all-zero channel/tensor must quantize to zeros, not divide by zero
SCALE_FLOOR = 1e-8

# K3's output tile (csrc/int8_mm.cu): 128 rows by 128 or 256 columns,
# k in stages of 128 bytes; the card's SM count, one block each: split-k
# aims at one wave when the output alone has too few tiles
_TILE_M = 128
_STAGE_K = 128
_SMS = 132
_MIN_STAGES_PER_SPLIT = 2


def per_channel_scale(w) -> np.ndarray:
    """Symmetric per-output-channel (dim 0) scale of a weight, host-side
    numpy float32: max(absmax, 1e-8) / 127 per channel."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    amax = np.abs(w.reshape(w.shape[0], -1)).max(axis=1)
    return (np.maximum(amax, np.float32(SCALE_FLOOR))
            / np.float32(127.0)).astype(np.float32)


def act_scale(amax: float) -> float:
    """The per-tensor activation scale, in Python float64 (it is
    rounded to float32 only when staged)."""
    return float(max(amax, SCALE_FLOOR)) / 127.0


def _f32(t, like: torch.Tensor) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=like.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(t, np.float32), device=like.device)


def quantize_weight(w: torch.Tensor, scale) -> torch.Tensor:
    """int8 weight against a frozen per-channel scale: multiply by the
    float32 reciprocal, round half to even, clip to [-127, 127]."""
    inv = (1.0 / _f32(scale, w)).reshape((-1,) + (1,) * (w.dim() - 1))
    q = torch.clamp(torch.round(w.float() * inv), -127, 127)
    return q.to(torch.int8)


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """int8 activation against the frozen per-tensor scale: x / s,
    round half to even, clip to [-127, 127]."""
    s = _f32(scale, x)
    q = torch.clamp(torch.round(x.float() / s), -127, 127)
    return q.to(torch.int8)


def dequantize(acc: torch.Tensor, act_scale_, w_scale) -> torch.Tensor:
    """int32 accumulator -> float32: acc * (act_scale * w_scale), the
    per-channel scale broadcast over (m, n) or (n, c, h, w)."""
    s = _f32(act_scale_, acc) * _f32(w_scale, acc)
    if acc.dim() == 4:
        return acc.float() * s[None, :, None, None]
    return acc.float() * s[None, :]


# ---------------------------------------------------------------------------
# the int8 dot: K3 and its plain version
# ---------------------------------------------------------------------------

def int8_matmul_reference(xq: torch.Tensor, wq: torch.Tensor
                          ) -> torch.Tensor:
    """The plain version of K3: `xq (m, k) . wq (n, k)^T` as an int32
    product. On the card, where cuBLAS has no integer product, the same
    sums run in float64: every product is at most 127^2 and every
    partial sum an integer far below 2^53, so float64 is exact and the
    result is the same int32."""
    if xq.is_cuda:
        return torch.mm(xq.double(), wq.double().t()).to(torch.int32)
    return torch.mm(xq.to(torch.int32), wq.to(torch.int32).t())


def _check(xq: torch.Tensor, wq: torch.Tensor) -> None:
    for name, t in (("x", xq), ("w", wq)):
        if not t.is_cuda:
            raise ValueError(f"int8_mm kernel: {name} must be a CUDA "
                             "tensor (the CPU path is "
                             "int8_matmul_reference)")
        if t.dtype != torch.int8:
            raise ValueError(f"int8_mm kernel: {name} dtype must be int8, "
                             f"got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"int8_mm kernel: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"int8_mm kernel: {name} must be contiguous")
    if xq.shape[1] != wq.shape[1] or xq.device != wq.device:
        raise ValueError(
            f"int8_mm kernel: x {tuple(xq.shape)} on {xq.device} and w "
            f"{tuple(wq.shape)} on {wq.device} must share k and a device")
    if xq.device.index != torch.cuda.current_device():
        # the C entry launches on the calling thread's current device
        raise ValueError(f"int8_mm kernel: x and w on {xq.device}, not on "
                         f"the current device cuda:"
                         f"{torch.cuda.current_device()}")
    if min(xq.shape[0], wq.shape[0], xq.shape[1]) < 1:
        raise ValueError("int8_mm kernel: empty operand")
    if max(xq.shape[0], wq.shape[0], xq.shape[1]) >= 2 ** 31:
        raise ValueError("int8_mm kernel: a dimension exceeds int32")


def k3_tile_n(n: int) -> int:
    """K3's tile width for n output columns: 256 or 128, whichever pads
    n less (256 on a tie: half the x re-reads)."""
    return 256 if -(-n // 256) * 256 <= -(-n // 128) * 128 else 128


def k3_splits(m: int, n: int, k: int) -> int:
    """Split-k factor: 1 when the output has enough 128 x k3_tile_n
    tiles to fill the card's SMs; else enough k ranges (each of at least
    two 128-byte stages) to reach about one block per SM."""
    tiles = -(-m // _TILE_M) * -(-n // k3_tile_n(n))
    if tiles >= _SMS:
        return 1
    return max(1, min(-(-k // _STAGE_K) // _MIN_STAGES_PER_SPLIT,
                      _SMS // tiles))


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """K3's wrapper: contiguous 2-D int8 CUDA tensors x (m, k) and
    w (n, k) -> int32 (m, n); anything else raises."""
    _check(xq, wq)
    m, k = xq.shape
    n = wq.shape[0]
    lib = kernels.load("int8_mm")
    # under split-k the C entry zeroes `out` before the atomic adds
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    aligned = int(k % 16 == 0 and xq.data_ptr() % 16 == 0
                  and wq.data_ptr() % 16 == 0)
    # the raw handle of the current stream: fc7 / fc8 at 64 rows take
    # about as long on the card as this call takes to enqueue them
    rc = lib.int8_mm(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, n, k,
                     k3_tile_n(n), k3_splits(m, n, k), aligned,
                     torch._C._cuda_getCurrentRawStream(xq.device.index))
    kernels.check("int8_mm", rc)
    return out


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """`xq (m, k) . wq (n, k)^T -> (m, n)` int32: K3 on a CUDA tensor,
    the plain version on a CPU one."""
    if xq.is_cuda:
        return int8_mm(xq.contiguous(), wq.contiguous())
    return int8_matmul_reference(xq, wq)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                pad_y: int, pad_x: int, num_group: int = 1,
                gemm=int8_matmul) -> torch.Tensor:
    """Grouped NCHW int8 convolution with exact int32 accumulation:
    im2col, then `gemm` (default `int8_matmul`: K3 on the card) per
    group. xq (b, c, h, w) int8; wq (o, c / g, ky, kx) int8."""
    b, c, h, w = xq.shape
    o, cg, ky, kx = wq.shape
    g = num_group
    og, kg = o // g, cg * ky * kx
    oh = (h + 2 * pad_y - ky) // stride + 1
    ow = (w + 2 * pad_x - kx) // stride + 1
    ft = torch.float16 if xq.is_cuda else torch.float32
    cols = F.unfold(xq.to(ft), (ky, kx), padding=(pad_y, pad_x),
                    stride=stride)  # (b, c*ky*kx, oh*ow), group-major
    rows = torch.empty((g, b, oh * ow, kg), dtype=torch.int8,
                       device=xq.device)
    rows.copy_(cols.view(b, g, kg, oh * ow).permute(1, 0, 3, 2))
    wg = wq.reshape(g, og, kg)
    acc = torch.stack([gemm(rows[i].view(b * oh * ow, kg), wg[i])
                       for i in range(g)])  # (g, b*oh*ow, og)
    return (acc.view(g, b, oh, ow, og).permute(1, 0, 4, 2, 3)
            .reshape(b, o, oh, ow))


def int8_conv2d_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                          pad_y: int, pad_x: int,
                          num_group: int = 1) -> torch.Tensor:
    """`int8_conv2d` with the plain GEMM on any device."""
    return int8_conv2d(xq, wq, stride, pad_y, pad_x, num_group,
                       gemm=int8_matmul_reference)
