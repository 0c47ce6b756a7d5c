"""Component registry namespace: the encoders, processors and decoders that
configs name by string (``"enc_grid.ElementWise"``, ``"UFNO"``,
``"dec_grid.TimeConvDense"``)."""

from nps_tpu_torch.models import enc_grid, dec_grid, gnn  # noqa: F401
from nps_tpu_torch.models.fno import FNO, FNO_Layer, SpectralConvND  # noqa: F401
from nps_tpu_torch.models.gnn import MPGNN  # noqa: F401
from nps_tpu_torch.models.moe_fno import MoEFNO  # noqa: F401
from nps_tpu_torch.models.ufno import UFNO  # noqa: F401
from nps_tpu_torch.models.unet_modern import UNetModern  # noqa: F401
from nps_tpu_torch.models.dilated_resnet import DilatedResnet  # noqa: F401
