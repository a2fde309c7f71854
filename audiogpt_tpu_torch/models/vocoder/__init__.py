from audiogpt_tpu_torch.models.vocoder.bigvgan import (  # noqa: F401
    BigVGANConfig, BigVGANGenerator)
from audiogpt_tpu_torch.models.vocoder.hifigan import (  # noqa: F401
    HifiGANConfig, HifiGANGenerator)
from audiogpt_tpu_torch.models.vocoder.pwg import (  # noqa: F401
    MelGANConfig, MelGANGenerator, PWGConfig, PWGGenerator)
from audiogpt_tpu_torch.models.vocoder.discriminators import (  # noqa: F401
    DiscriminatorConfig, HifiGANDiscriminator)
