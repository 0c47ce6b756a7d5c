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

One process only: the multi-process branches raise (ROADMAP P9b).
"""

import queue
import threading

import numpy as np
import torch

_P9 = ("multi-process data loading is not ported yet (ROADMAP P9b, "
       "data parallel)")


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


class HostDataLoader:
    """Shuffled epoch iterator over an index-able dataset of 6-tuples. The
    order comes from ``np.random.default_rng(seed)``, one permutation per
    epoch, as in the JAX package."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=False, process_index=0, process_count=1):
        if process_count != 1 or process_index != 0:
            raise NotImplementedError(_P9)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield collate([self.dataset[int(i)] for i in idx])


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
    batches on the device. Yields the same 6-tuple layout, as tensors."""

    device_resident = True  # trainers skip the host prefetch

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=False, device="cpu", cache_dtype=None):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        n = len(dataset)
        host = collate([dataset[i] for i in range(n)])
        dtype = (getattr(torch, cache_dtype) if isinstance(cache_dtype, str)
                 else cache_dtype)
        self._cache = tuple(torch.from_numpy(a).to(self.device, dtype=dtype)
                            for a in host)
        self._n = n

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(self._n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, self._n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
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
    the elements' own time lengths."""

    def __init__(self, dataset, batch_sampler, mode="min", time_window=25,
                 seed=0, process_index=0, process_count=1):
        from nps_tpu_torch.utils.collate import collate_batch_sim

        if process_count != 1 or process_index != 0:
            raise NotImplementedError(_P9)
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.mode = mode
        self.tw = time_window
        self._collate_u = collate_batch_sim(t_dim=1, mode=mode,
                                            tw=time_window)
        self._rng = np.random.default_rng(seed)
        lengths = getattr(batch_sampler, "lengths", None)
        if lengths is None:
            lengths = np.array([dataset[i][1].shape[1]
                                for i in range(len(dataset))])
        self._lengths = np.asarray(lengths)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        from nps_tpu_torch.utils.collate import min_crop_starts

        for idxs in self.batch_sampler:
            idxs = [int(i) for i in idxs]
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
