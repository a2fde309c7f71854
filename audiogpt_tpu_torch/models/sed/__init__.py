from audiogpt_tpu_torch.models.sed.panns_sed import (  # noqa: F401
    SEDConfig,
    SEDModel,
    audioset_labels,
    detect_events,
)
from audiogpt_tpu_torch.models.sed.pvt import PVTConfig, PVTSED  # noqa: F401
from audiogpt_tpu_torch.models.sed.tsd import (  # noqa: F401
    TSDConfig,
    TSDModel,
    decode_timestamps,
    median_filter,
)
