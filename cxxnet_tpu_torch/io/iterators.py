"""IIterator base protocol (src/io/data.h:18-38; counterpart of
cxxnet_tpu/io/iterators.py without the retry wrapper, which belongs to
the fault-tolerance layer not yet ported)."""

from __future__ import annotations

from typing import Generic, TypeVar

T = TypeVar("T")


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
