"""Training recipes (counterpart of ``audiogpt_tpu/train/tasks``): the T2A
latent diffusion (``ldm``), FastSpeech2 (``fs2``) and the HiFi-GAN vocoder
GAN (``vocoder_gan``) so far."""

from audiogpt_tpu_torch.train.tasks.fs2 import FS2Task, FS2TaskConfig
from audiogpt_tpu_torch.train.tasks.ldm import LDMTask, LDMTaskConfig
from audiogpt_tpu_torch.train.tasks.vocoder_gan import (VocoderGANTask,
                                                        VocoderGANTaskConfig)

__all__ = ["FS2Task", "FS2TaskConfig", "LDMTask", "LDMTaskConfig",
           "VocoderGANTask", "VocoderGANTaskConfig"]
