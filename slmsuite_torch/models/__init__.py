"""Ready-to-run engine workloads of the port; ``parallel_models`` holds
the batched multiplane model."""

from slmsuite_torch.models.engine_models import (  # noqa: F401
    EngineModel,
    spot_array_target,
    spot_array_wgs,
)
