"""Data parallelism across processes, ZeRO-1 and spatial parallelism
(counterpart of ``nps_tpu/parallel``). Tensor, pipeline and expert
parallelism (ROADMAP P9b items 4-6) are not ported; the trainer refuses
them."""

from nps_tpu_torch.parallel.mesh import (  # noqa: F401
    AllReduceGrads, Grid, all_reduce_, gather_rows, global_sum,
    init_distributed, replicate, world)
from nps_tpu_torch.parallel.multihost import (  # noqa: F401
    process_slice, shard_indices_for_process, validate_grid_layout)
from nps_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialAxis, fetch_rows, halo_exchange, spatial_sum)
from nps_tpu_torch.parallel.zero import Zero1, state_bytes  # noqa: F401
