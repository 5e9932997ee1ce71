"""Per-instance augmentation (counterpart of cxxnet_tpu/io/augment.py).

AugmentIterator parity (src/io/iter_augment_proc-inl.hpp:21-246):
random/fixed crop to input_shape, random mirror, scale / divideby,
mean-image subtraction (with first-run mean computation + caching) or
per-channel mean_value, random contrast/illumination. Affine warps
(rotation / shear / aspect-ratio / random scale composed into one warp)
follow ImageAugmenter (src/io/image_augmenter-inl.hpp:13-204), implemented
with scipy.ndimage instead of cv::warpAffine.

Channel convention: images are loaded RGB; `mean_value = b,g,r` keeps the
reference's (BGR) config order and is applied to the matching channels.

The draws come from one numpy RandomState (0 + seed_data) in the JAX
package's order, so the two packages give the same instances bit for bit.
Under `device_augment = 1` the instances pass through raw and the
trainer augments on the device (ops/augment.py).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from cxxnet_tpu_torch.io.data import DataInst
from cxxnet_tpu_torch.io.iterators import DataIter, say


class ImageAugmenter:
    """Affine warp + crop (image_augmenter-inl.hpp)."""

    def __init__(self) -> None:
        self.shape = None  # (c, y, x)
        self.rand_crop = 0
        self.max_rotate_angle = 0.0
        self.max_aspect_ratio = 0.0
        self.max_shear_ratio = 0.0
        self.min_crop_size = -1
        self.max_crop_size = -1
        self.rotate = -1.0
        self.max_random_scale = 1.0
        self.min_random_scale = 1.0
        self.min_img_size = 0.0
        self.max_img_size = 1e10
        self.fill_value = 255
        self.rotate_list: List[int] = []

    def set_param(self, name: str, val: str) -> None:
        if name == "input_shape":
            self.shape = tuple(int(t) for t in val.split(","))
        if name == "rand_crop":
            self.rand_crop = int(val)
        if name == "max_rotate_angle":
            self.max_rotate_angle = float(val)
        if name == "max_shear_ratio":
            self.max_shear_ratio = float(val)
        if name == "max_aspect_ratio":
            self.max_aspect_ratio = float(val)
        if name == "min_crop_size":
            self.min_crop_size = int(val)
        if name == "max_crop_size":
            self.max_crop_size = int(val)
        if name == "min_random_scale":
            self.min_random_scale = float(val)
        if name == "max_random_scale":
            self.max_random_scale = float(val)
        if name == "min_img_size":
            self.min_img_size = float(val)
        if name == "max_img_size":
            self.max_img_size = float(val)
        if name == "fill_value":
            self.fill_value = int(val)
        if name == "rotate":
            self.rotate = int(val)
        if name == "rotate_list":
            self.rotate_list = [int(t) for t in val.split(",")]

    def need_process(self) -> bool:
        if (self.max_rotate_angle > 0 or self.max_shear_ratio > 0
                or self.rotate > 0 or self.rotate_list):
            return True
        if self.min_crop_size > 0 and self.max_crop_size > 0:
            return True
        return False

    def process(self, data: np.ndarray,
                rng: np.random.RandomState) -> np.ndarray:
        """data: (c, h, w) float; returns (c, h', w')."""
        if not self.need_process():
            return data
        from scipy import ndimage

        c, rows, cols = data.shape
        s = rng.uniform(-self.max_shear_ratio, self.max_shear_ratio)
        if self.max_rotate_angle > 0:
            angle = rng.randint(0, int(self.max_rotate_angle * 2) + 1) \
                - self.max_rotate_angle
        else:
            angle = 0
        if self.rotate > 0:
            angle = self.rotate
        if self.rotate_list:
            angle = self.rotate_list[rng.randint(0, len(self.rotate_list))]
        a = np.cos(angle / 180.0 * np.pi)
        b = np.sin(angle / 180.0 * np.pi)
        scale = rng.uniform(self.min_random_scale, self.max_random_scale)
        ratio = rng.uniform(-self.max_aspect_ratio,
                            self.max_aspect_ratio) + 1.0
        hs = 2 * scale / (1 + ratio)
        ws = ratio * hs
        new_w = int(max(self.min_img_size,
                        min(self.max_img_size, scale * cols)))
        new_h = int(max(self.min_img_size,
                        min(self.max_img_size, scale * rows)))
        # forward map (x', y') = M @ (x, y) + t  (image_augmenter:86-95)
        m00 = hs * a - s * b * ws
        m01 = hs * b + s * a * ws
        m10 = -b * ws
        m11 = a * ws
        t0 = (new_w - (m00 * cols + m01 * rows)) / 2
        t1 = (new_h - (m10 * cols + m11 * rows)) / 2
        # scipy wants the inverse map from output coords to input coords
        fwd = np.array([[m00, m01, t0], [m10, m11, t1], [0, 0, 1]],
                       dtype=np.float64)
        inv = np.linalg.inv(fwd)
        # affine_transform matrix is in (row, col) order
        mat = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
        off = np.array([inv[1, 2], inv[0, 2]])
        out = np.empty((c, new_h, new_w), dtype=data.dtype)
        for ch in range(c):
            out[ch] = ndimage.affine_transform(
                data[ch], mat, offset=off, output_shape=(new_h, new_w),
                order=1, mode="constant", cval=self.fill_value)

        # optional random crop-size crop + resize back to >= input shape
        if self.min_crop_size > 0 and self.max_crop_size > 0:
            cs = rng.randint(self.min_crop_size, self.max_crop_size + 1)
            cs = min(cs, out.shape[1], out.shape[2])
            yy = rng.randint(0, out.shape[1] - cs + 1)
            xx = rng.randint(0, out.shape[2] - cs + 1)
            crop = out[:, yy:yy + cs, xx:xx + cs]
            ty, tx = self.shape[1], self.shape[2]
            zy, zx = ty / crop.shape[1], tx / crop.shape[2]
            out = np.stack([
                ndimage.zoom(crop[ch], (zy, zx), order=1)
                for ch in range(c)])
        return out


def load_mean_image(path: str) -> np.ndarray:
    """Load a mean image, auto-detecting the format.

    Reference files are mshadow Tensor<cpu,3>::LoadBinary payloads
    (iter_augment_proc-inl.hpp:84): uint32 shape[3] = (c, y, x) followed
    by packed little-endian float32 data - the same SaveBinary layout the
    checkpoint weights use (nnet/legacy_format.py). Files written by
    earlier rounds of this repo are .npy; sniffed by the numpy magic.
    """
    with open(path, "rb") as fi:
        head = fi.read(6)
        fi.seek(0)
        if head == b"\x93NUMPY":
            return np.load(fi)
        shape = np.frombuffer(fi.read(12), "<u4")
        n = int(shape.prod())
        data = np.frombuffer(fi.read(4 * n), "<f4")
        if data.size != n:
            raise ValueError(
                f"{path}: truncated mean image (expected {n} floats)")
        return data.reshape(tuple(int(s) for s in shape)).copy()


def save_mean_image(path: str, mean: np.ndarray) -> None:
    """Write the reference SaveBinary layout
    (iter_augment_proc-inl.hpp:193) so reference binaries can consume
    the file."""
    if mean.ndim != 3:
        raise ValueError("mean image must be (c, y, x)")
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as fo:
        fo.write(np.asarray(mean.shape, "<u4").tobytes())
        fo.write(np.ascontiguousarray(mean, "<f4").tobytes())


class AugmentIterator(DataIter):
    """Crop/mirror/scale/mean pipeline over a DataInst iterator."""

    K_RAND_MAGIC = 0

    def __init__(self, base: DataIter):
        self.base = base
        self.rand_crop = 0
        self.rand_mirror = 0
        self.crop_y_start = -1
        self.crop_x_start = -1
        self.scale = 1.0
        self.silent = 0
        self.name_meanimg = ""
        self.mean_b = self.mean_g = self.mean_r = 0.0
        self.mirror = 0
        self.max_random_illumination = 0.0
        self.max_random_contrast = 0.0
        self.shape = None  # (c, y, x)
        self.device_augment = 0
        self.aug = ImageAugmenter()
        self.rng = np.random.RandomState(self.K_RAND_MAGIC)
        self.meanimg: Optional[np.ndarray] = None

    def set_param(self, name: str, val: str) -> None:
        self.base.set_param(name, val)
        if name == "input_shape":
            self.shape = tuple(int(t) for t in val.split(","))
        if name == "seed_data":
            self.rng = np.random.RandomState(self.K_RAND_MAGIC + int(val))
        if name == "rand_crop":
            self.rand_crop = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "divideby":
            self.scale = 1.0 / float(val)
        if name == "scale":
            self.scale = float(val)
        if name == "image_mean":
            self.name_meanimg = val
        if name == "crop_y_start":
            self.crop_y_start = int(val)
        if name == "crop_x_start":
            self.crop_x_start = int(val)
        if name == "rand_mirror":
            self.rand_mirror = int(val)
        if name == "mirror":
            self.mirror = int(val)
        if name == "max_random_contrast":
            self.max_random_contrast = float(val)
        if name == "max_random_illumination":
            self.max_random_illumination = float(val)
        if name == "mean_value":
            self.mean_b, self.mean_g, self.mean_r = (
                float(t) for t in val.split(","))
        if name == "device_augment":
            self.device_augment = int(val)
        self.aug.set_param(name, val)

    def init(self) -> None:
        self.base.init()
        if self.name_meanimg:
            if os.path.exists(self.name_meanimg):
                say(self.silent,
                    f"loading mean image from {self.name_meanimg}")
                self.meanimg = load_mean_image(self.name_meanimg)
            else:
                self._create_mean_img()

    def before_first(self) -> None:
        self.base.before_first()

    def next(self) -> bool:
        if not self.base.next():
            return False
        self._set_data(self.base.value())
        return True

    def value(self) -> DataInst:
        return self._out

    # ------------------------------------------------------------------
    def _set_data(self, d: DataInst) -> None:
        if self.device_augment:
            # passthrough: stage the RAW decoded image; crop / mirror /
            # mean / scale run on the device inside the trainer's step
            # (ops/augment.py). Affine warps cannot be deferred -
            # they run scipy on the host.
            if self.aug.need_process():
                raise ValueError(
                    "device_augment=1 cannot defer affine augmenters "
                    "(rotate/shear/aspect/random-scale run on the "
                    "host); disable them or device_augment")
            self._out = DataInst(index=d.index,
                                 data=np.ascontiguousarray(d.data),
                                 label=d.label, extra_data=d.extra_data)
            return
        data = self.aug.process(d.data, self.rng)
        c, ty, tx = self.shape

        if ty == 1:  # flat input: scale only
            img = data.astype(np.float32) * self.scale
            self._out = DataInst(index=d.index, data=img, label=d.label,
                                 extra_data=d.extra_data)
            return

        if data.shape[1] < ty or data.shape[2] < tx:
            raise ValueError(
                "data size must not be smaller than the net input size")
        yy_max = data.shape[1] - ty
        xx_max = data.shape[2] - tx
        if self.rand_crop and (yy_max or xx_max):
            yy = self.rng.randint(0, yy_max + 1)
            xx = self.rng.randint(0, xx_max + 1)
        else:
            yy, xx = yy_max // 2, xx_max // 2
        if data.shape[1] != ty and self.crop_y_start != -1:
            yy = self.crop_y_start
        if data.shape[2] != tx and self.crop_x_start != -1:
            xx = self.crop_x_start

        contrast = (self.rng.uniform() * self.max_random_contrast * 2
                    - self.max_random_contrast + 1)
        illumination = (self.rng.uniform() * self.max_random_illumination * 2
                        - self.max_random_illumination)
        do_mirror = ((self.rand_mirror and self.rng.uniform() < 0.5)
                     or self.mirror == 1)

        x = data.astype(np.float32)
        if self.mean_r > 0.0 or self.mean_g > 0.0 or self.mean_b > 0.0:
            # RGB layout; config order is b,g,r (see module docstring)
            x = x.copy()
            if x.shape[0] == 3:
                x[2] -= self.mean_b
                x[1] -= self.mean_g
                x[0] -= self.mean_r
            x = x * contrast + illumination
            img = x[:, yy:yy + ty, xx:xx + tx]
        elif self.meanimg is None:
            img = x[:, yy:yy + ty, xx:xx + tx]
        else:
            if x.shape == self.meanimg.shape:
                x = (x - self.meanimg) * contrast + illumination
                img = x[:, yy:yy + ty, xx:xx + tx]
            else:
                img = ((x[:, yy:yy + ty, xx:xx + tx] - self.meanimg)
                       * contrast + illumination)
        if do_mirror:
            img = img[:, :, ::-1]
        img = img * self.scale
        self._out = DataInst(index=d.index,
                             data=np.ascontiguousarray(img),
                             label=d.label, extra_data=d.extra_data)

    def _create_mean_img(self) -> None:
        say(self.silent, f"cannot find {self.name_meanimg}: creating mean "
                         "image, this will take some time...")
        # accumulate the *processed* instances exactly like CreateMeanImg
        # (meanimg is None here so _set_data performs no subtraction)
        self.base.before_first()
        acc = None
        cnt = 0
        while self.next():
            x = self._out.data.astype(np.float64)
            if acc is None:
                acc = np.zeros_like(x)
            acc += x
            cnt += 1
        mean = (acc / max(cnt, 1)).astype(np.float32)
        save_mean_image(self.name_meanimg, mean)
        self.meanimg = mean
        self.base.before_first()
