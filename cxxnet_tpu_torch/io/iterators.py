"""IIterator base protocol (src/io/data.h:18-38; counterpart of
cxxnet_tpu/io/iterators.py without the retry wrapper, which belongs to
the fault-tolerance layer not yet ported)."""

from __future__ import annotations

from typing import Dict, Generic, Tuple, TypeVar


T = TypeVar("T")

# Iterator keys of the JAX package's data pipeline that the port does not
# implement yet (the image iterators, the augmenter, the batch / buffer
# adapters and the retry wrapper): any value but the JAX default raises
# NotImplementedError naming the key (utils.config.check_ported, called
# by the ported iterators). A chain naming those iterators raises at its
# `iter =` line already.
_NOT_PORTED: Dict[str, Tuple[str, ...]] = {
    "image_list": (), "image_root": (), "image_bin": (),
    "image_conf_prefix": (), "image_conf_ids": (), "filename": ("",),
    "use_native": ("-1",), "decode_threads": ("4",),
    "shuffle_buffer": ("1024",), "label_width": ("1",),
    "round_batch": ("0",), "test_skipread": ("0",), "buffer_size": ("2",),
    "max_nbatch": ("0",), "io_retry": ("3",), "io_retry_backoff": ("0.05",),
    "max_rotate_angle": ("0",), "max_aspect_ratio": ("0",),
    "max_shear_ratio": ("0",), "min_crop_size": ("-1",),
    "max_crop_size": ("-1",), "min_random_scale": ("1",),
    "max_random_scale": ("1",), "min_img_size": ("0",),
    "max_img_size": ("1e10",), "fill_value": ("255",), "rotate": ("-1",),
    "rotate_list": ("",),
}



class DataIter(Generic[T]):
    """SetParam / Init / BeforeFirst / Next / Value protocol."""

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    def value(self) -> T:
        raise NotImplementedError

    # iteration sugar
    def __iter__(self):
        self.before_first()
        while self.next():
            yield self.value()
