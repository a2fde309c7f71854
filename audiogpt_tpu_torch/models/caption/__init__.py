from audiogpt_tpu_torch.models.caption.cnn14 import (  # noqa: F401
    Cnn14Config,
    Cnn14Encoder,
    ConvBlock,
)
from audiogpt_tpu_torch.models.caption.blip import (  # noqa: F401
    BlipCaptioner,
    BlipConfig,
    BlipTextConfig,
    BlipVisionConfig,
    greedy_caption,
)
