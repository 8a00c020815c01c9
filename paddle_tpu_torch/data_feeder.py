"""DataFeeder: reader minibatches -> feed dicts of dense arrays
(counterpart of paddle_tpu/data_feeder.py).

Reference: python/paddle/fluid/data_feeder.py — DataToLoDTensorConverter
builds LoDTensors per feed var; here sequence (lod_level>0) slots become a
dense padded array PLUS the companion "<name>.lens" int32 vector declared
by layers.data (static ranks; raggedness is carried as lengths).

Batches should keep a consistent max length (pad_to) across steps where
possible: every new padded length is a new feed signature, so a new
captured step.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .framework.core import Program, Variable, default_main_program
from .framework.dtypes import as_numpy_dtype
from .framework.scope import CPUPlace

__all__ = ["DataFeeder"]


class _SlotConverter:
    def __init__(self, var: Variable):
        self.var = var
        self.dtype = as_numpy_dtype(var.dtype)
        self.data: List[np.ndarray] = []

    def feed(self, item):
        self.data.append(np.asarray(item))

    def done(self, pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        name = self.var.name
        if self.var.lod_level == 0:
            arr = np.stack([d.astype(self.dtype) for d in self.data])
            # honor declared trailing shape, e.g. data(shape=[1]) fed scalars
            want = [s for s in self.var.shape if s > 0]
            if want and list(arr.shape[1:]) != want and arr.size == len(self.data) * int(np.prod(want)):
                arr = arr.reshape([len(self.data)] + want)
            return {name: arr}
        # sequence slot: pad to batch max (or pad_to) + lengths vector
        lens = np.array([len(d) for d in self.data], np.int32)
        maxlen = int(pad_to) if pad_to else (int(lens.max()) if len(lens) else 0)
        tail = self.data[0].shape[1:] if self.data and self.data[0].ndim > 1 else ()
        out = np.zeros((len(self.data), maxlen) + tuple(tail), self.dtype)
        for i, d in enumerate(self.data):
            n = min(len(d), maxlen)
            out[i, :n] = d[:n].astype(self.dtype)
        np.minimum(lens, maxlen, out=lens)
        return {name: out, name + ".lens": lens}


class DataFeeder:
    """
    feeder = DataFeeder(feed_list=[x, y], place=CUDAPlace(0))
    exe.run(feed=feeder.feed(minibatch), ...)

    Reference: data_feeder.py:DataFeeder. The feed dict holds host
    arrays; the executor's step copies them onto its device. ``place``
    sets the device count ``decorate_reader(multi_devices=True)`` splits
    by when no ``num_places`` is given: 1 on the CPU, the visible cards
    otherwise (None, like the Executor, means the card).
    """

    def __init__(self, feed_list: Sequence, place=None, program: Optional[Program] = None,
                 pad_to: Optional[int] = None):
        self.place = place
        if program is None:
            program = default_main_program()
        self.feed_vars: List[Variable] = []
        for item in feed_list:
            if isinstance(item, str):
                item = program.global_block().var(item)
            self.feed_vars.append(item)
        self.pad_to = pad_to

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """iterable: list of per-sample tuples aligned with feed_list."""
        converters = [_SlotConverter(v) for v in self.feed_vars]
        n = len(converters)
        for row in iterable:
            if len(row) != n:
                raise ValueError(
                    "each sample must have %d slots, got %d" % (n, len(row)))
            for conv, item in zip(converters, row):
                conv.feed(item)
        out: Dict[str, np.ndarray] = {}
        for conv in converters:
            out.update(conv.done(self.pad_to))
        return out

    def feed_parallel(self, iterable, num_places: Optional[int] = None):
        """Reference parity: yields one feed dict per device batch."""
        for batch in iterable:
            yield self.feed(batch)

    def _device_count(self) -> int:
        if isinstance(self.place, CPUPlace):
            return 1
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "DataFeeder.decorate_reader(multi_devices=True) splits by the "
                "visible CUDA devices and there is none: pass num_places, or "
                "place=CPUPlace()")
        return n

    def decorate_reader(self, reader, multi_devices: bool = False,
                        num_places: Optional[int] = None, drop_last: bool = True):
        """Wrap a batch reader into a feed-dict reader (reference:
        data_feeder.py:decorate_reader)."""

        def __reader_creator__():
            if not multi_devices:
                for item in reader():
                    yield self.feed(item)
            else:
                n = num_places or self._device_count()
                for item in reader():
                    if len(item) % n != 0:
                        if not drop_last:
                            # reference semantics: an indivisible final
                            # batch with drop_last=False is an error (the
                            # dp sharding cannot scatter it)
                            raise ValueError(
                                "batch of %d samples is not divisible by "
                                "the %d devices and drop_last=False; use "
                                "drop_last=True or pad the dataset"
                                % (len(item), n)
                            )
                        item = item[: len(item) // n * n]
                        if not item:
                            continue
                    yield self.feed(item)

        return __reader_creator__
