"""Data parallelism across processes and ZeRO-1 (counterpart of
``nps_tpu/parallel``). Spatial, tensor, pipeline and expert parallelism
(ROADMAP P9b items 3-6) are not ported; the trainer refuses them."""

from nps_tpu_torch.parallel.mesh import (  # noqa: F401
    AllReduceGrads, all_reduce_, gather_rows, global_sum, init_distributed,
    replicate, world)
from nps_tpu_torch.parallel.multihost import (  # noqa: F401
    process_slice, shard_indices_for_process)
from nps_tpu_torch.parallel.zero import Zero1, state_bytes  # noqa: F401
