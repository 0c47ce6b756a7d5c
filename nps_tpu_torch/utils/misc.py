"""Misc host-side utilities (counterpart of ``nps_tpu/utils/misc.py``):
logging, metric formatting, batch sizing, parameter counts, and the graph
helpers of the GNN path."""

import random
import string
import time

import numpy as np
import torch


class Logger:
    """Stdout wrapper that flushes after every write (slurm-friendly)."""

    def __init__(self, default_stdout, write_log=False, filename="log.txt"):
        self.terminal = default_stdout
        self.write_log = write_log
        if self.write_log:
            self.log = open(filename, "a")

    def write(self, message):
        if self.write_log:
            self.log.write(message)
            self.log.flush()
        self.terminal.write(message)
        self.terminal.flush()

    def flush(self):
        if self.write_log:
            self.log.flush()
        self.terminal.flush()

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)


def to_float(x):
    if isinstance(x, float):
        return x
    if hasattr(x, "item"):
        return float(x.item())
    return float(x)


def to_floatdict(x):
    return {k: to_float(v) for k, v in x.items()}


def to_floatlist(x):
    return [to_float(v) for v in x]


def dict_str(x, prefix="", mapping=": ", postfix="", subdir_prefix="  "):
    return "\n".join(
        f"{prefix}{k}{mapping}{v}{postfix}" if not isinstance(v, dict) else
        f"{prefix}{k}{mapping}\n"
        f"{dict_str(v, prefix=subdir_prefix + prefix, mapping=mapping, postfix=postfix)}{postfix}"
        for (k, v) in x.items())


def _numel(x):
    return x.numel() if isinstance(x, torch.Tensor) else np.size(x)


def get_batch_size(batch):
    """Infer the leading batch dimension from a tuple of arrays, tensors or
    lists; empty roles ([b, 0]) are skipped."""
    n = -1
    for x in batch:
        if hasattr(x, "shape") and len(x.shape) > 0:
            if _numel(x) == 0:
                continue
            if n != -1:
                assert n == x.shape[0]
            else:
                n = x.shape[0]
        elif isinstance(x, list):
            if n != -1:
                assert n == len(x)
            else:
                n = len(x)
    if n == -1:
        raise ValueError("Could not determine batch size from batch of data!")
    return int(n)


def random_timestr(n=10):
    curr = str(round(time.time() * 1000))
    alphabet = string.ascii_uppercase + string.ascii_lowercase + string.digits
    return curr + "".join(random.choices(alphabet, k=n))


def get_graph_from_batch(u, pos, batch, idx):
    """Select one batch element's nodes from a flattened graph batch."""
    u, pos, batch = (np.asarray(v) for v in (u, pos, batch))
    sel = batch == idx
    return u[sel], pos[sel]


def grid_graph_to_array(u, pos, batch, dxs):
    """Rasterize grid-structured graph nodes back into image arrays.

    Node positions are assumed to lie on a regular grid with spacings
    ``dxs`` per spatial dimension (``pos[:, 0]`` is time and is ignored
    for placement). Returns ``[b, c, t, *dims]``.

    u: [N, c, t] node values; pos: [N, 1+nd]; batch: [N] element ids.
    """
    u, pos, batch = (np.asarray(v) for v in (u, pos, batch))
    batch_size = int(batch.max()) + 1
    out = []
    for b in range(batch_size):
        u_b, pos_b = get_graph_from_batch(u, pos, batch, b)
        sp = pos_b[:, 1:]  # spatial columns
        idx = (sp - sp.min(axis=0)) / np.asarray(dxs, np.float64)
        idx_int = np.rint(idx).astype(np.int64)
        if not np.allclose(idx, idx_int):
            raise ValueError("node positions do not lie on a regular grid "
                             "with the given dxs")
        dims = tuple(int(d) + 1 for d in idx_int.max(axis=0))
        num_c, num_t = u_b.shape[1:]
        img = np.zeros((num_c, num_t) + dims, u_b.dtype)
        img[(slice(None), slice(None)) + tuple(idx_int.T)] = \
            u_b.transpose(1, 2, 0)  # [c, t, nx] scatter into [c, t, *dims]
        out.append(img)
    return np.stack(out)


def count_parameters(params):
    """Count the elements of a module's parameters (or of an iterable of
    tensors or arrays)."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return sum(int(np.prod(p.shape)) for p in params)
