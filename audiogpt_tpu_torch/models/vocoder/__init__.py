from audiogpt_tpu_torch.models.vocoder.bigvgan import (  # noqa: F401
    BigVGANConfig, BigVGANGenerator)
