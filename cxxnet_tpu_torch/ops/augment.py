"""Device-side image augmentation: crop / mean / contrast / illumination /
mirror / scale on the trainer's device (counterpart of
cxxnet_tpu/ops/augment_jit.py's make_device_augment).

Under `device_augment = 1` the iterator passes the RAW decoded images
through (io/augment.py; uint8 batches cross to the card at 1/4 the
float32 bytes) and the trainer applies this function to the staged
batch at the head of each forward:

- crop FIRST, with per-sample offsets, by index arithmetic (one gather
  over the batch - O(crop) work, not O(raw)), cast to float32;
- subtract the mean (per-channel `mean_value`, or a mean image that is
  either crop-sized - what `_create_mean_img` writes, since it averages
  processed instances - or raw-sized, cropped with the same offsets);
- contrast and illumination (on the mean-subtracting branches only: the
  host pipeline's no-mean branch skips them, and so does this one);
- mirror the difference with a per-sample flag (torch.where over the
  flipped batch);
- multiply by `scale`. The trainer then casts to the compute dtype.

These are the host pipeline's operations (io/augment.py `_set_data`) on
the same float32 values in the same order, with the crop commuted ahead
of the elementwise ones: given the host's draws, the result is the host's
bit for bit. Batched stock torch ops - the JAX function is plain jnp, not
a Pallas kernel.

Randomness (train only): one torch.Generator on the batch's device,
seeded by the trainer from stream_seed(seed + 100, step, AUGMENT_STREAM)
- the port's stand-in for the JAX package's fold_in(step rng, 0xA6), as
for dropout; the two streams never agree, so tests inject the draws. The
draws are taken in a fixed order (crop rows, crop columns, mirror flags,
contrast and illumination uniforms), all five every step. The eval path
(train=False) is deterministic: centre crop (or crop_y/x_start), the
`mirror` flag alone, no jitter.

Affine warps (rotation/shear/aspect/random-scale) cannot be deferred -
they run scipy on the host - so the passthrough iterator rejects them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Shape3 = Tuple[int, int, int]

# the stream index the trainer seeds the draws from: one past every
# layer index, which the dropout streams use
AUGMENT_STREAM = -1


def draw_augment(gen: torch.Generator, b: int, yy_max: int,
                 xx_max: int) -> Dict[str, torch.Tensor]:
    """The five per-sample draws of one training batch from `gen`, on its
    device: crop offsets in [0, yy_max] and [0, xx_max], mirror flags
    (p = 0.5) and the contrast / illumination uniforms in [0, 1)
    (float64, mapped as the host pipeline maps its RandomState
    uniforms)."""
    dev = gen.device
    return {
        "yy": torch.randint(0, yy_max + 1, (b,), generator=gen, device=dev),
        "xx": torch.randint(0, xx_max + 1, (b,), generator=gen, device=dev),
        "mirror": torch.rand(b, generator=gen, device=dev) < 0.5,
        "contrast": torch.rand(b, generator=gen, device=dev,
                               dtype=torch.float64),
        "illumination": torch.rand(b, generator=gen, device=dev,
                                   dtype=torch.float64),
    }


def make_device_augment(out_shape: Shape3,
                        mean_loader: Optional[Callable] = None,
                        mean_values: Optional[Tuple[float, float, float]]
                        = None,
                        scale: float = 1.0,
                        rand_crop: int = 0, rand_mirror: int = 0,
                        mirror: int = 0,
                        crop_y_start: int = -1, crop_x_start: int = -1,
                        max_random_contrast: float = 0.0,
                        max_random_illumination: float = 0.0,
                        ) -> Callable:
    """Build `apply(data, train, gen=None, draws=None) -> (b, c, ty, tx)
    float32`.

    out_shape: the net's (c, ty, tx) input_shape; the raw shape is read
    from the batch. mean_loader: nullary callable returning the (c, ry,
    rx)- or (c, ty, tx)-shaped float32 mean array (or None), called at
    the first apply - after the iterator had its chance to create the
    mean file - and cached on the batch's device. mean_values wins over
    the mean image, the host pipeline's precedence. A training apply
    takes its draws from `gen` (draw_augment) or, injected, from `draws`
    (the same keys)."""
    c, ty, tx = out_shape
    if mean_values is not None and not any(mean_values):
        # all-zero mean_value is OFF on the host path (the branch tests
        # mean_r/g/b > 0), which also disables contrast/illumination
        mean_values = None
    if mean_values is not None:
        mean_loader = None
    has_mean = mean_loader is not None or mean_values is not None
    cache: Dict[str, Optional[torch.Tensor]] = {}

    def mean_on(dev: torch.device) -> Optional[torch.Tensor]:
        """The mean to subtract, on `dev` (loaded once, then cached per
        device)."""
        if "host" not in cache:
            if mean_values is not None:
                mb, mg, mr = mean_values
                cache["host"] = (torch.tensor([mr, mg, mb],
                                              dtype=torch.float32)[
                                                  :, None, None]
                                 if c == 3 else None)
            elif mean_loader is not None:
                cache["host"] = torch.as_tensor(mean_loader(),
                                                dtype=torch.float32)
            else:
                cache["host"] = None
        key = str(dev)
        if key not in cache:
            host = cache["host"]
            cache[key] = None if host is None else host.to(dev)
        return cache[key]

    def apply(data: torch.Tensor, train: bool,
              gen: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
        b, dc, ry, rx = data.shape
        if dc != c or ty > ry or tx > rx:
            raise ValueError(
                f"device_augment: raw batch {tuple(data.shape[1:])} cannot "
                f"produce net input {out_shape}")
        dev = data.device
        mean = mean_on(dev)
        if mean_values is None and mean is not None and tuple(
                mean.shape) not in ((c, ry, rx), (c, ty, tx)):
            raise ValueError(
                f"device_augment: mean image {tuple(mean.shape)} matches "
                f"neither the raw shape {(c, ry, rx)} nor the crop "
                f"shape {(c, ty, tx)}")
        yy_max, xx_max = ry - ty, rx - tx
        if train and draws is None:
            if gen is None:
                raise ValueError("device_augment: a training apply needs "
                                 "a generator or injected draws")
            draws = draw_augment(gen, b, yy_max, xx_max)

        def full(v, dtype=torch.int64):
            return torch.full((b,), v, dtype=dtype, device=dev)

        if train and rand_crop and (yy_max or xx_max):
            yy, xx = draws["yy"].to(dev), draws["xx"].to(dev)
        else:
            yy, xx = full(yy_max // 2), full(xx_max // 2)
        # fixed crop offsets override both the centre and a random draw,
        # as on the host; range-checked, since the gather below would
        # read out of bounds where the host path fails on the shape
        if yy_max and crop_y_start != -1:
            if not 0 <= crop_y_start <= yy_max:
                raise ValueError(
                    f"device_augment: crop_y_start={crop_y_start} out "
                    f"of range [0, {yy_max}] for raw {ry} crop {ty}")
            yy = full(crop_y_start)
        if xx_max and crop_x_start != -1:
            if not 0 <= crop_x_start <= xx_max:
                raise ValueError(
                    f"device_augment: crop_x_start={crop_x_start} out "
                    f"of range [0, {xx_max}] for raw {rx} crop {tx}")
            xx = full(crop_x_start)
        if train and rand_mirror and not mirror:
            mir = draws["mirror"].to(dev)
        else:
            # mirror = 1 forces every sample, also under rand_mirror:
            # the host ORs the two flags
            mir = full(bool(mirror), torch.bool)

        rows = (yy[:, None] + torch.arange(ty, device=dev))[:, None, :, None]
        cols = (xx[:, None] + torch.arange(tx, device=dev))[:, None, None, :]
        chan = torch.arange(c, device=dev)[None, :, None, None]
        x = data[torch.arange(b, device=dev)[:, None, None, None], chan,
                 rows, cols].to(torch.float32)
        if mean is not None:
            if mean_values is None and tuple(mean.shape) == (c, ry, rx):
                # crop-then-subtract == subtract-then-crop (elementwise)
                x = x - mean[chan, rows, cols]
            else:
                x = x - mean
        if has_mean:
            con = torch.ones(b, dtype=torch.float32, device=dev)
            ill = torch.zeros(b, dtype=torch.float32, device=dev)
            if train and max_random_contrast > 0:
                mc = max_random_contrast
                con = (draws["contrast"].to(dev) * mc * 2 - mc + 1).to(
                    torch.float32)
            if train and max_random_illumination > 0:
                mi = max_random_illumination
                ill = (draws["illumination"].to(dev) * mi * 2 - mi).to(
                    torch.float32)
            x = x * con[:, None, None, None] + ill[:, None, None, None]
        # mirror AFTER the subtraction (the host path mirrors the
        # mean-subtracted crop, not the raw pixels)
        x = torch.where(mir[:, None, None, None], x.flip(-1), x)
        return x * scale

    return apply
