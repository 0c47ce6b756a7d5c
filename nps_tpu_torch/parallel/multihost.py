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
Under spatial parallelism (a (data, x) grid, ``parallel.mesh.Grid``) the
loaders' process index and count are the data slice's index and the data
extent: the K ranks of one x group load the same elements and each keeps
its rows (:func:`validate_grid_layout` holds the layout's conditions).
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



# the config key that sets each grid axis
AXIS_KEYS = {"x": "spatial_parallel", "model": "tensor_parallel",
             "pipe": "pipeline_parallel", "expert": "expert_parallel"}


def validate_grid_layout(process_count, k, name="x"):
    """The grid's conditions (``validate_grid_mesh_process_layout`` in the
    JAX package, one device per process here): K > 1 divides the world, so
    that every process owns one (data slice, axis index) cell and every
    data slice is owned whole by the K processes of its axis group."""
    k, key = int(k), AXIS_KEYS[name]
    if k < 2:
        raise ValueError(f"a (data, {name}) grid needs {key} > 1, got {k}")
    if process_count % k:
        raise ValueError(
            f"{key} ({k}) must divide the world of {process_count} "
            f"processes: an {name} group split across data slices would "
            f"need an input slice no loader produces")
