"""Ready-to-run engine workloads of the port."""

from slmsuite_torch.models.engine_models import (  # noqa: F401
    EngineModel,
    spot_array_target,
    spot_array_wgs,
)
