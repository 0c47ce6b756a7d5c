"""Data parallelism across processes, ZeRO-1, and the (data, axis) grids of
spatial, tensor, pipeline and expert parallelism (counterpart of
``nps_tpu/parallel``): ``mesh`` (the world, the grid, the gradient sums),
:func:`scope` (the grid axis of the model applies inside, which each
regime's ops read by its name), ``spatial``, ``tensor``, ``pipeline`` and
``expert`` (each axis's collectives, and the trainer's hooks of each
regime: ``check``, ``setup``, ``partial_params``, and under tensor and
expert parallelism ``shard_state`` and ``merge``), ``zero``."""

from nps_tpu_torch.parallel.mesh import (  # noqa: F401
    AllReduceGrads, GradSums, Grid, all_reduce_, gather_rows, global_sum,
    init_distributed, replicate, world)
from nps_tpu_torch.parallel.multihost import (  # noqa: F401
    process_slice, shard_indices_for_process, validate_grid_layout)
from nps_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialAxis, fetch_rows, halo_exchange, scope, spatial_sum)
from nps_tpu_torch.parallel.zero import Zero1, state_bytes  # noqa: F401
