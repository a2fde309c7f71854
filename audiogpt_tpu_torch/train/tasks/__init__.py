"""Training recipes (counterpart of ``audiogpt_tpu/train/tasks``): the T2A
latent diffusion (``ldm``) so far."""

from audiogpt_tpu_torch.train.tasks.ldm import LDMTask, LDMTaskConfig

__all__ = ["LDMTask", "LDMTaskConfig"]
