"""2-D convolution on NCHW tensors (counterpart of cxxnet_tpu/ops/conv.py).

The JAX package hands convolution to XLA (`lax.conv_general_dilated`);
the port hands it to cuDNN through `F.conv2d`, grouped convs through
`groups`. Output-size parity (convolution_layer-inl.hpp:174-177):

    out = (in + 2*pad - k) // stride + 1

The JAX package's space-to-depth rewrite of the input conv is a TPU
matrix-unit trick that computes the same sums regrouped; the port
accepts the `space_to_depth` key and leaves it inert. `s2d_auto` is the
port's copy of that rewrite's predicate: the `space_to_depth` graph
pass stamps its decision, which the port's convolution then ignores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# the input-channel cap of the space-to-depth auto heuristic
_S2D_MAX_IN_CH = 4


def s2d_auto(in_ch: int, stride: int, ky: int, kx: int,
             num_group: int = 1) -> bool:
    """The space-to-depth auto predicate (cxxnet_tpu/ops/conv.py):
    ungrouped, strided, the kernel covers the stride, and a tiny input
    channel count."""
    return (num_group == 1 and stride > 1
            and min(ky, kx) >= stride and in_ch <= _S2D_MAX_IN_CH)


def conv_out_dim(in_dim: int, ksize: int, stride: int, pad: int) -> int:
    """The reference convolution output-size formula."""
    return (in_dim + 2 * pad - ksize) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, pad_y: int,
           pad_x: int, num_group: int = 1) -> torch.Tensor:
    """Grouped 2-D convolution, no bias.

    x: (batch, in_ch, h, w); w: (out_ch, in_ch // num_group, ky, kx).
    Float32 on the card runs in TF32 when
    `torch.backends.cudnn.allow_tf32` is True (torch's default); a
    float32 NetTrainer on the card turns it off, as the reference runs
    float32 convolutions at full precision."""
    return F.conv2d(x, w, None, stride=stride, padding=(pad_y, pad_x),
                    groups=num_group)
