"""Host -> device input pipeline (counterpart of ``nps_tpu/data/pipeline.py``).

- :class:`HostDataLoader` shuffles and collates numpy batches on the host;
- :func:`prefetch_to_device` stages them on the device from a background
  thread while the current step computes: the next batch is copied into
  pinned host memory and sent with ``non_blocking=True`` on a side CUDA
  stream; the consumer's stream waits for that copy, and each tensor is
  recorded on the consumer's stream so the allocator does not reuse it
  early;
- :class:`DeviceCacheLoader` keeps a whole split on the device and gathers
  batches there;
- :class:`VariableTimeLoader` batches variable-length (``D.sim1d_var_t``)
  simulations through a batch sampler, cropped to the batch's shortest or
  padded to its longest, with their lengths; its batches take the same
  pinned copy through :func:`prefetch_to_device`.

Several processes (data parallelism, ``nps_tpu_torch.parallel``, one
device a process): every process derives the same global batches from the
shared seed, trims each to a multiple of the process count and keeps its
contiguous slice (``parallel.multihost.process_slice``); the defaults of
``process_index`` and ``process_count`` are the process group's rank and
size. Under spatial parallelism the trainer passes the data slice's index
and the data extent instead, so the K ranks of an x group load the same
elements; each keeps its rows of the fields, ``pos`` and ``spatial_cond``
(``parallel.mesh.Grid.shard_batch``, cut on the host before the copy).
"""

import queue
import threading

import numpy as np
import torch

from nps_tpu_torch.parallel.multihost import (process_slice,
                                              shard_indices_for_process)
from nps_tpu_torch.parallel.mesh import world


def collate(elements):
    """Stack a list of 6-tuples into batch arrays; empty roles -> [b, 0]."""
    n = len(elements)
    out = []
    for i in range(len(elements[0])):
        parts = [e[i] for e in elements]
        if parts[0].size == 0:
            out.append(np.zeros((n, 0), dtype=np.float32))
        else:
            out.append(np.stack(parts).astype(np.float32, copy=False))
    return tuple(out)


def _fleet(process_index, process_count):
    """(process_index, process_count), each from the process group where
    not given."""
    rank, size = world()
    pi = rank if process_index is None else int(process_index)
    pc = size if process_count is None else int(process_count)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index={pi} is not one of the "
                         f"{pc} processes")
    return pi, pc


def _empty_split(n, batch_size, process_count):
    """The refusal of a split none of whose global batches survives the
    trim to a multiple of the process count."""
    return ValueError(
        f"every batch of this split ({n} elements, batch_size={batch_size}) "
        f"trims to zero on {process_count} processes: use a global batch "
        f"and splits of at least the process count — a multi-process run "
        f"cannot fall back to replication, no process holds the full batch")


class HostDataLoader:
    """Shuffled epoch iterator over an index-able dataset of 6-tuples. The
    order comes from ``np.random.default_rng(seed)``, one permutation per
    epoch, as in the JAX package.

    Several processes: every process derives the same global order from
    the shared ``seed``, trims each global batch to a multiple of the
    process count and collates only its contiguous slice; ``__len__`` and
    the order are the same on every process."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=False, process_index=None, process_count=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.process_index, self.process_count = _fleet(process_index,
                                                        process_count)
        if self.process_count > 1 and not len(self):
            raise _empty_split(len(dataset), batch_size, self.process_count)

    def __len__(self):
        return _count_batches(len(self.dataset), self.batch_size,
                              self.drop_last, self.process_count)

    def __iter__(self):
        for idx in _global_batches(len(self.dataset), self.batch_size,
                                   self.shuffle, self._rng, self.drop_last,
                                   self.process_count):
            if self.process_count > 1:
                idx = shard_indices_for_process(idx, self.process_index,
                                                self.process_count)
            yield collate([self.dataset[int(i)] for i in idx])


def _global_batches(n, batch_size, shuffle, rng, drop_last, process_count):
    """One epoch's global batches of element indices: a permutation from
    ``rng`` (or the identity), cut into batches, each trimmed to a multiple
    of ``process_count``."""
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        idx = idx[:len(idx) - len(idx) % process_count]
        if len(idx):
            yield idx


def _count_batches(n, batch_size, drop_last, process_count):
    """The number of batches of one epoch (the same on every process)."""
    return sum(1 for _ in _global_batches(n, batch_size, False, None,
                                          drop_last, process_count))


def _stage(batch, device, stream):
    """Host arrays -> tensors on ``device``; on CUDA through pinned memory,
    copied on ``stream``. Returns (tensors, event the copy records)."""
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    if device.type != "cuda":
        return tuple(t.to(device) for t in tensors), None
    with torch.cuda.stream(stream):
        out = tuple(t.pin_memory().to(device, non_blocking=True)
                    for t in tensors)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def prefetch_to_device(iterator, device, size=2):
    """Yield the batches of ``iterator`` as tensors on ``device``, staged
    ``size`` ahead by a background thread (see the module note).

    The consumer may stop early (``max_train_batches``, an exception in the
    step): the generator's ``finally`` sets a stop event and drains the
    queue, so the worker exits instead of blocking on a full queue."""
    device = torch.device(device)
    q = queue.Queue(maxsize=size)
    end = object()
    err = []
    stop = threading.Event()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def worker():
        try:
            for batch in iterator:
                item = _stage(batch, device, stream)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer below
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(end, timeout=0.2)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            tensors, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for x in tensors:
                    x.record_stream(current)
            yield tensors
    finally:
        stop.set()
        while True:  # release a worker blocked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)


class DeviceCacheLoader:
    """Device-resident dataset cache: the whole split is collated once and
    kept on ``device`` as tensors (float roles cast to ``cache_dtype`` if
    given, e.g. ``"bfloat16"``); each epoch shuffles indices on the host
    with the same generator as :class:`HostDataLoader` and gathers the
    batches on the device. Yields the same 6-tuple layout, as tensors.

    Several processes: every process caches the whole split (a process's
    slices cover all of it over an epoch's shuffles) and gathers exactly
    the elements :class:`HostDataLoader` would give it."""

    device_resident = True  # trainers skip the host prefetch

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=False, device="cpu", cache_dtype=None,
                 process_index=None, process_count=None):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self.process_index, self.process_count = _fleet(process_index,
                                                        process_count)
        n = len(dataset)
        host = collate([dataset[i] for i in range(n)])
        dtype = (getattr(torch, cache_dtype) if isinstance(cache_dtype, str)
                 else cache_dtype)
        self._cache = tuple(torch.from_numpy(a).to(self.device, dtype=dtype)
                            for a in host)
        self._n = n

    def __len__(self):
        return _count_batches(self._n, self.batch_size, self.drop_last,
                              self.process_count)

    def __iter__(self):
        for idx in _global_batches(self._n, self.batch_size, self.shuffle,
                                   self._rng, self.drop_last,
                                   self.process_count):
            if self.process_count > 1:
                idx = shard_indices_for_process(idx, self.process_index,
                                                self.process_count)
            sel = torch.as_tensor(idx, device=self.device)
            yield tuple(
                torch.zeros((len(idx), 0), device=self.device)
                if a.shape[1:] == (0,) else a.index_select(0, sel)
                for a in self._cache)


class VariableTimeLoader:
    """Loader for ``D.sim1d_var_t`` (counterpart of the JAX package's
    ``VariableTimeLoader``): a batch sampler picks the element groups; the
    collate crops every element to the batch minimum (``mode="min"``,
    training: one random window start per element, shared by every role,
    from the loader's own ``np.random.default_rng(seed)``) or pads it with
    zeros to the maximum (``mode="max"``, evaluation), both rounded to
    ``time_window`` multiples. Yields the 7-tuple ``(u_base, u, x, cond,
    t_cond, spatial_cond, lengths)`` of numpy arrays, ``lengths`` [b] int32
    the elements' own time lengths.

    Several processes: every process runs the same seeded batch sampler
    (the same global batches and per-batch unroll depths), trims each
    global batch to a multiple of the process count, takes the crop or
    pad extent and the crop starts over the global batch, then collates
    only its contiguous slice."""

    def __init__(self, dataset, batch_sampler, mode="min", time_window=25,
                 seed=0, process_index=None, process_count=None):
        from nps_tpu_torch.utils.collate import collate_batch_sim

        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.mode = mode
        self.tw = time_window
        self._collate_u = collate_batch_sim(t_dim=1, mode=mode,
                                            tw=time_window)
        self._rng = np.random.default_rng(seed)
        self.process_index, self.process_count = _fleet(process_index,
                                                        process_count)
        lengths = getattr(batch_sampler, "lengths", None)
        if lengths is None:
            lengths = np.array([dataset[i][1].shape[1]
                                for i in range(len(dataset))])
        self._lengths = np.asarray(lengths)
        # the batches that survive the trim: a ragged final batch shrinks
        # to a multiple of the process count and is dropped where it trims to
        # zero (__len__ is the trainer's loss denominator)
        self._n_batches = len(batch_sampler)
        if self.process_count > 1:
            bs = getattr(batch_sampler, "batch_size", None)
            wr = getattr(batch_sampler, "with_replacement", None)
            if bs is not None and wr is not None:
                n = len(dataset)
                sizes = ([bs] * len(batch_sampler) if wr else
                         [min(bs, n - s) for s in range(0, n, bs)])
                pc = self.process_count
                self._n_batches = sum(1 for s in sizes if s >= pc)
            if self._n_batches == 0:
                raise _empty_split(len(dataset), bs, self.process_count)

    def __len__(self):
        return self._n_batches

    def __iter__(self):
        from nps_tpu_torch.utils.collate import min_crop_starts

        pc = self.process_count
        for idxs in self.batch_sampler:
            idxs = [int(i) for i in idxs]
            if pc > 1:
                idxs = idxs[:len(idxs) - len(idxs) % pc]
                if not idxs:
                    continue
            # the extent and the crop starts of the global batch, the same
            # draws on every process, then this process's slice
            lengths_b = self._lengths[idxs]
            if self.mode == "min":
                shape_t = int(lengths_b.min())
                shape_t -= shape_t % self.tw
                starts = min_crop_starts(lengths_b, self.tw, rng=self._rng)
            else:
                shape_t = int(lengths_b.max())
                if shape_t % self.tw:
                    shape_t += self.tw - shape_t % self.tw
                starts = None
            if pc > 1:
                lo, hi = process_slice(len(idxs), self.process_index, pc)
                idxs = idxs[lo:hi]
                starts = starts[lo:hi] if starts is not None else None
            els = [self.dataset[i] for i in idxs]
            n = len(els)

            def roles(k, crop):
                parts = [e[k] for e in els]
                if not sum(e.size for e in parts):
                    return np.zeros((n, 0), np.float32)
                if crop:
                    return self._collate_u(parts, starts=starts,
                                           shape_t=shape_t).astype(np.float32)
                return np.stack(parts).astype(np.float32)

            lengths = np.array([e[1].shape[1] for e in els], np.int32)
            yield (roles(0, True), roles(1, True),
                   np.stack([e[2] for e in els]).astype(np.float32),
                   roles(3, False), roles(4, True), roles(5, False), lengths)
