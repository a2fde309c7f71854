"""Training recipes (counterpart of ``audiogpt_tpu/train/tasks``): the T2A
latent diffusion (``ldm``), FastSpeech2 (``fs2``), the HiFi-GAN vocoder
GAN (``vocoder_gan``), PortaSpeech and SyntaSpeech (``portaspeech``), the
adversarial ``ps_adv`` family and its FastSpeech2 counterpart
(``tts_adv``), GenerSpeech (``generspeech``) and the pitch extractor
(``pe``) so far."""

from audiogpt_tpu_torch.train.tasks.fs2 import FS2Task, FS2TaskConfig
from audiogpt_tpu_torch.train.tasks.generspeech import (GenerSpeechTask,
                                                        GenerSpeechTaskConfig)
from audiogpt_tpu_torch.train.tasks.ldm import LDMTask, LDMTaskConfig
from audiogpt_tpu_torch.train.tasks.pe import PETask, PETaskConfig
from audiogpt_tpu_torch.train.tasks.portaspeech import (PortaSpeechTask,
                                                        PortaSpeechTaskConfig)
from audiogpt_tpu_torch.train.tasks.tts_adv import (AdvTTSTask,
                                                    AdvTTSTaskConfig,
                                                    PortaSpeechAdvTask,
                                                    PortaSpeechAdvTaskConfig)
from audiogpt_tpu_torch.train.tasks.vocoder_gan import (VocoderGANTask,
                                                        VocoderGANTaskConfig)

__all__ = ["AdvTTSTask", "AdvTTSTaskConfig", "FS2Task", "FS2TaskConfig",
           "GenerSpeechTask", "GenerSpeechTaskConfig", "LDMTask",
           "LDMTaskConfig", "PETask", "PETaskConfig", "PortaSpeechAdvTask",
           "PortaSpeechAdvTaskConfig", "PortaSpeechTask",
           "PortaSpeechTaskConfig", "VocoderGANTask", "VocoderGANTaskConfig"]
