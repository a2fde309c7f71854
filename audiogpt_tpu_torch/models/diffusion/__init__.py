from audiogpt_tpu_torch.models.diffusion.unet import UNetModel, UNetConfig  # noqa: F401
from audiogpt_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig  # noqa: F401
from audiogpt_tpu_torch.models.diffusion.samplers import (  # noqa: F401
    DiffusionSchedule,
    ddim_sample,
    ddpm_sample,
    dpmpp_sample,
    plms_sample,
)
