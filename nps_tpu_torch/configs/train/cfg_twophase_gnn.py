"""MP-PDE-style message-passing GNN on twophase (counterpart of
``nps_tpu/configs/train/cfg_twophase_gnn.py``).

The model consumes a static-shape grid graph built from the twophase grid
with the ``NS`` radius rule (``neighbors`` grid spacings along the
diagonal, +1e-4): with ``neighbors=2`` that is 24 integer offsets, so the
processor takes the shifted-grid path (``models/gnn.py``). ``remat`` and
``edge_chunks`` are kept as the JAX config has them: the shifted path has
no per-edge tensors to recompute or slice.
"""

from nps_tpu_torch.configs.parse_component import load_config_modules, compose_config
from nps_tpu_torch.configs.train._twophase_shared import (
    make_base, make_dataset, make_trainer)
from nps_tpu_torch.models.activations import Swish

base_args, parser = make_base()

model = dict(
    object="EncProcDec",
    num_c=1,
    num_spatial_dims=2,
    time_window=base_args.time_window,
    data_structure="graph",
    processor_residual=False,
    encoder="gnn.NodeElementWise",
    processor="MPGNN",
    decoder="gnn.NodeTimeConvDense",
    activation=Swish(),
    hidden_features=128,
    hidden_blocks=6,
    aggregate="mean",
    remat=False,
    edge_chunks=1,
    dec_delta_mode="per_step",
)

_, optimizer, lr_scheduler, _, criterion, _ = load_config_modules(base_args)

trainer = dict(make_trainer(base_args), neighbors=2)

compose_config(parser,
               base_args=base_args,
               dataset=make_dataset(base_args),
               optimizer=optimizer.Adam,
               lr_scheduler=lr_scheduler.MultiStepLR,
               model=model,
               criterion=criterion.MSE_sum,
               trainer=trainer)
