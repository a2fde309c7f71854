"""Singing-voice synthesis: DiffSinger (``diffsinger``) and VISinger
(``visinger``)."""

from audiogpt_tpu_torch.models.svs.diffsinger import (  # noqa: F401
    DiffNet,
    DiffNetConfig,
    DiffSinger,
    DiffSingerConfig,
    plms_interval_sample,
)
from audiogpt_tpu_torch.models.svs.visinger import (  # noqa: F401
    VISinger,
    VISingerConfig,
)
