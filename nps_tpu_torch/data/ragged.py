"""Ragged (variable-length) memmap storage (the port's own copy of
``nps_tpu/data/ragged.py``, plain numpy).

The reference stores variable-length 1D simulations with mmap_ninja's
RaggedMmap (``src/data/memmap_dataset.py:7,29-40``). This is a
dependency-free equivalent with the same access pattern (index -> ndarray,
zero-copy reads from a flat memmap):

    <dir>/data.npy     flat concatenation of all elements (ravelled)
    <dir>/offsets.npy  [n+1] int64 start offsets into data
    <dir>/shapes.npy   [n, ndim] int64 per-element shapes

Interop: reference-produced mmap_ninja directories load unchanged —
``open_ragged`` auto-detects the layout, and
``RaggedMemmap.from_mmap_ninja`` reads the library's flat-buffer +
offsets + flattened-shapes files with plain numpy (see
:class:`MmapNinjaReader`).
"""

import os
import warnings

import numpy as np


class RaggedMemmap:
    def __init__(self, dirname):
        self.dirname = dirname
        self.data = np.lib.format.open_memmap(
            os.path.join(dirname, "data.npy"), mode="r")
        self.offsets = np.load(os.path.join(dirname, "offsets.npy"))
        self.shapes = np.load(os.path.join(dirname, "shapes.npy"))

    def __len__(self):
        return len(self.shapes)

    def __getitem__(self, idx):
        lo, hi = self.offsets[idx], self.offsets[idx + 1]
        return np.asarray(self.data[lo:hi]).reshape(self.shapes[idx])

    @staticmethod
    def save(dirname, arrays, dtype=np.float32):
        os.makedirs(dirname, exist_ok=True)
        arrays = [np.asarray(a, dtype=dtype) for a in arrays]
        ndim = arrays[0].ndim
        assert all(a.ndim == ndim for a in arrays)
        sizes = [a.size for a in arrays]
        offsets = np.zeros(len(arrays) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        flat = np.lib.format.open_memmap(
            os.path.join(dirname, "data.npy"), mode="w+", dtype=dtype,
            shape=(int(offsets[-1]),))
        for a, lo in zip(arrays, offsets[:-1]):
            flat[lo:lo + a.size] = a.ravel()
        flat.flush()
        del flat
        np.save(os.path.join(dirname, "offsets.npy"), offsets)
        np.save(os.path.join(dirname, "shapes.npy"),
                np.array([a.shape for a in arrays], np.int64))
        return RaggedMemmap(dirname)

    @staticmethod
    def from_mmap_ninja(dirname):
        """Open a reference-produced mmap_ninja ``RaggedMmap`` directory
        (``src/data/memmap_dataset.py:7,29-40``) without the dependency.
        Returns a reader with the same ``__len__``/``__getitem__`` contract
        as :class:`RaggedMemmap`."""
        return MmapNinjaReader(dirname)


def _ninja_text_or_ints(path):
    """A small mmap_ninja metadata file: text (dtype/order/shape tuple) or
    raw little-endian int64/int32 bytes, depending on library version.
    Returns (text, ints) with the unused one None."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        text = raw.decode("ascii").strip()
        if text and all(c.isprintable() or c.isspace() for c in text):
            return text, None
    except UnicodeDecodeError:
        pass
    for dt in (np.int64, np.int32):
        if len(raw) % np.dtype(dt).itemsize == 0:
            return None, np.frombuffer(raw, dtype=dt)
    raise ValueError(f"unreadable mmap_ninja metadata file: {path}")


def _parse_int_tuple(text):
    toks = (text.replace("(", " ").replace(")", " ").replace("[", " ")
            .replace("]", " ").replace(",", " ").split())
    return tuple(int(t) for t in toks)


def _read_ninja_array(dirname):
    """One array in mmap_ninja's numpy persistence convention:
    ``<dir>/data.ninja`` raw bytes + ``dtype.ninja`` / ``shape.ninja``
    (and optional ``order.ninja``) sidecar files."""
    with open(os.path.join(dirname, "dtype.ninja"), "rb") as f:
        dtype = np.dtype(f.read().decode("ascii").strip())
    shape = None
    spath = os.path.join(dirname, "shape.ninja")
    if os.path.exists(spath):
        text, ints = _ninja_text_or_ints(spath)
        shape = _parse_int_tuple(text) if text is not None else tuple(
            int(v) for v in ints)
    order = "C"
    opath = os.path.join(dirname, "order.ninja")
    if os.path.exists(opath):
        with open(opath, "rb") as f:
            order = f.read().decode("ascii").strip() or "C"
    data_path = os.path.join(dirname, "data.ninja")
    if shape in (None, ()):
        n = os.path.getsize(data_path) // dtype.itemsize
        shape = (n,)
    return np.memmap(data_path, dtype=dtype, shape=tuple(shape),
                     order=order, mode="r")


class MmapNinjaReader:
    """Plain-numpy reader for an mmap_ninja ``RaggedMmap`` directory.

    Layout: the directory itself persists the flat ravelled buffer
    (``data.ninja`` + ``dtype/shape/order.ninja``); the ragged metadata —
    per-element start offsets and flattened shapes — lives in nested
    one-array subdirectories in the same convention. Metadata roles are
    identified by name where possible ("starts"/"offsets"/"ends",
    "shapes"/"flattened_shapes", "shapes_offsets" for mixed-ndim stores)
    and validated structurally (integer dtype, monotone offsets,
    prod(shape) == element extent), so naming differences across library
    versions fail loudly instead of mis-reading.
    """

    def __init__(self, dirname):
        self.dirname = dirname
        flat = _read_ninja_array(dirname)
        if flat.ndim > 1 and not flat.flags["C_CONTIGUOUS"]:
            # an F-order multi-dim buffer cannot be C-ravelled as a view;
            # re-open the raw bytes 1-D so reads stay memmap-backed
            # instead of silently materialising the whole store in RAM
            flat = np.memmap(os.path.join(dirname, "data.ninja"),
                             dtype=flat.dtype, mode="r",
                             shape=(flat.size,), order="C")
            warnings.warn(
                f"{dirname}: order='F' flat buffer; element reads assume "
                f"the ragged offsets index the on-disk (column-major) "
                f"ravel order, as mmap_ninja wrote them")
        self.data = flat.reshape(-1) if flat.ndim > 1 else flat

        meta = {}
        for name in sorted(os.listdir(dirname)):
            sub = os.path.join(dirname, name)
            if os.path.isdir(sub) and \
                    os.path.exists(os.path.join(sub, "data.ninja")):
                meta[name.lower()] = np.asarray(_read_ninja_array(sub))

        def pick(*keys):
            for k in keys:
                for name, arr in meta.items():
                    if k in name:
                        return name, arr
            return None, None

        sh_off_name, shapes_offsets = pick("shapes_offset", "shape_offset")
        if sh_off_name:
            del meta[sh_off_name]
        shapes_name, shapes = pick("flattened_shape", "shape")
        if shapes_name:
            del meta[shapes_name]
        _, ends = pick("end")
        starts_name, starts = pick("start", "offset", "begin")
        if starts is None:  # fall back: the remaining monotone int array
            for name, arr in meta.items():
                a = arr.reshape(-1)
                if np.issubdtype(a.dtype, np.integer) and len(a) and \
                        np.all(np.diff(a.astype(np.int64)) >= 0):
                    starts = arr
                    break
        if starts is None or shapes is None:
            raise ValueError(
                f"{dirname}: could not locate mmap_ninja ragged metadata "
                f"(found sub-arrays: {sorted(meta)}); expected start-offset "
                f"and flattened-shape arrays")
        starts = np.asarray(starts).reshape(-1).astype(np.int64)
        if ends is not None:
            ends = np.asarray(ends).reshape(-1).astype(np.int64)

        shapes = np.asarray(shapes)
        if shapes_offsets is not None:  # mixed-ndim store: ragged shapes
            so = np.asarray(shapes_offsets).reshape(-1).astype(np.int64)
            flat_sh = shapes.reshape(-1).astype(np.int64)
            if len(so) == 0 or so[0] != 0:
                so = np.concatenate([[0], so])
            self._shapes = [tuple(flat_sh[so[i]:so[i + 1]])
                            for i in range(len(so) - 1)]
        elif shapes.ndim == 2:
            self._shapes = [tuple(int(v) for v in row) for row in shapes]
        else:
            flat_sh = shapes.reshape(-1).astype(np.int64)
            n = len(ends) if ends is not None else (
                len(starts) - 1 if len(starts) and
                starts[-1] == self.data.size else len(starts))
            if n and len(flat_sh) % n == 0:
                nd = len(flat_sh) // n
                self._shapes = [tuple(flat_sh[i * nd:(i + 1) * nd])
                                for i in range(n)]
            else:
                raise ValueError(
                    f"{dirname}: cannot split flattened shapes of length "
                    f"{len(flat_sh)} into {n} elements")

        n = len(self._shapes)
        if ends is not None:
            self._starts, self._ends = starts[:n], ends[:n]
        elif len(starts) == n + 1:
            self._starts, self._ends = starts[:-1], starts[1:]
        else:
            self._starts = starts[:n]
            self._ends = np.concatenate([starts[1:n],
                                         [self.data.size]]).astype(np.int64)
        # structural validation: every element's extent matches its shape
        for i in range(n):
            want = int(np.prod(self._shapes[i], dtype=np.int64))
            got = int(self._ends[i] - self._starts[i])
            if want != got:
                raise ValueError(
                    f"{dirname}: element {i} extent {got} != "
                    f"prod(shape {self._shapes[i]}) = {want}; refusing to "
                    f"mis-read a ragged store with unrecognized metadata")

    def __len__(self):
        return len(self._shapes)

    def __getitem__(self, idx):
        lo, hi = int(self._starts[idx]), int(self._ends[idx])
        return np.asarray(self.data[lo:hi]).reshape(self._shapes[idx])


def open_ragged(dirname):
    """Open a ragged store, auto-detecting the layout: our ``data.npy``
    RaggedMemmap or a reference-produced mmap_ninja ``data.ninja`` dir."""
    if (not os.path.exists(os.path.join(dirname, "data.npy"))
            and os.path.exists(os.path.join(dirname, "data.ninja"))):
        return MmapNinjaReader(dirname)
    return RaggedMemmap(dirname)
