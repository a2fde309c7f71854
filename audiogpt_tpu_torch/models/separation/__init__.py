from audiogpt_tpu_torch.models.separation.convtasnet import (  # noqa: F401
    ConvTasNet,
    ConvTasNetConfig,
    separate_streaming,
)
from audiogpt_tpu_torch.models.separation.skim import (  # noqa: F401
    SkiM,
    SkiMConfig,
)
