"""Per-process input slices of a global batch (counterpart of
``nps_tpu/parallel/multihost.py``).

Every process shares the loader's shuffle seed, so each derives the same
global epoch order, and materialises only its contiguous slice of every
global batch (:func:`process_slice`). The JAX package then lifts the
slices into global ``jax.Array``s (``assemble_global_batch``); the port has
no global array, each rank trains on its slice, and the trainer sums what
the global batch needs over the world (``parallel.mesh``). What
``assemble_global_batch`` checks is the loaders': every global batch is
trimmed to a multiple of the process count, and a split whose batches all
trim to zero is refused (no process holds the full batch to fall back on).
The grid variants belong to spatial parallelism (ROADMAP P9b item 3).
"""

from nps_tpu_torch.parallel.mesh import world


def process_slice(n, process_index=None, process_count=None):
    """Contiguous per-process slice ``(start, stop)`` of a global batch of
    ``n`` elements, the batch first trimmed to a multiple of
    ``process_count`` (at most ``process_count - 1`` trailing elements of a
    final ragged batch are dropped). ``start == stop`` means this batch is
    dropped fleet-wide. The defaults are the process group's rank and
    size."""
    rank, size = world()
    process_index = rank if process_index is None else process_index
    process_count = size if process_count is None else process_count
    per = n // process_count
    return process_index * per, (process_index + 1) * per


def shard_indices_for_process(idx, process_index=None, process_count=None):
    """Slice one global batch's element indices down to this process's."""
    start, stop = process_slice(len(idx), process_index, process_count)
    return idx[start:stop]

