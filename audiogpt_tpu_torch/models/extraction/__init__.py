from audiogpt_tpu_torch.models.extraction.lassnet import (  # noqa: F401
    LASSNet,
    LASSNetConfig,
)
