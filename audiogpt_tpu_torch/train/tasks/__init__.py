"""Training recipes (counterpart of ``audiogpt_tpu/train/tasks``): the T2A
latent diffusion (``ldm``), the first-stage VAE GAN (``vae``) and CLAP
pretraining (``clap``) of its family, FastSpeech2 (``fs2``), the HiFi-GAN
vocoder GAN (``vocoder_gan``), PortaSpeech and SyntaSpeech
(``portaspeech``), the adversarial ``ps_adv`` family and its FastSpeech2
counterpart (``tts_adv``), GenerSpeech (``generspeech``), the pitch
extractor (``pe``), the SVS recipes DiffSinger (``diffusion``) and VISinger
(``visinger``), GeneFace's motion generator (``audio2motion``), and the
analysis recipes: AudioSet tagging (``sed``), audio captioning
(``caption``) and separation / enhancement (``separation``)."""

from audiogpt_tpu_torch.train.tasks.audio2motion import (
    Audio2MotionTask, Audio2MotionTaskConfig)
from audiogpt_tpu_torch.train.tasks.caption import (CaptionTask,
                                                    CaptionTaskConfig)
from audiogpt_tpu_torch.train.tasks.clap import CLAPTask, CLAPTaskConfig
from audiogpt_tpu_torch.train.tasks.diffusion import (DiffSingerTask,
                                                      DiffSingerTaskConfig)
from audiogpt_tpu_torch.train.tasks.fs2 import FS2Task, FS2TaskConfig
from audiogpt_tpu_torch.train.tasks.generspeech import (GenerSpeechTask,
                                                        GenerSpeechTaskConfig)
from audiogpt_tpu_torch.train.tasks.ldm import LDMTask, LDMTaskConfig
from audiogpt_tpu_torch.train.tasks.pe import PETask, PETaskConfig
from audiogpt_tpu_torch.train.tasks.portaspeech import (PortaSpeechTask,
                                                        PortaSpeechTaskConfig)
from audiogpt_tpu_torch.train.tasks.sed import SEDTask, SEDTaskConfig
from audiogpt_tpu_torch.train.tasks.separation import (SeparationTask,
                                                       SeparationTaskConfig)
from audiogpt_tpu_torch.train.tasks.tts_adv import (AdvTTSTask,
                                                    AdvTTSTaskConfig,
                                                    PortaSpeechAdvTask,
                                                    PortaSpeechAdvTaskConfig)
from audiogpt_tpu_torch.train.tasks.vae import VAETask, VAETaskConfig
from audiogpt_tpu_torch.train.tasks.visinger import (VISingerTask,
                                                     VISingerTaskConfig)
from audiogpt_tpu_torch.train.tasks.vocoder_gan import (VocoderGANTask,
                                                        VocoderGANTaskConfig)

__all__ = ["AdvTTSTask", "AdvTTSTaskConfig", "Audio2MotionTask",
           "Audio2MotionTaskConfig", "CaptionTask", "CaptionTaskConfig",
           "CLAPTask", "CLAPTaskConfig",
           "DiffSingerTask", "DiffSingerTaskConfig", "FS2Task",
           "FS2TaskConfig", "GenerSpeechTask", "GenerSpeechTaskConfig",
           "LDMTask", "LDMTaskConfig", "PETask", "PETaskConfig",
           "PortaSpeechAdvTask", "PortaSpeechAdvTaskConfig",
           "PortaSpeechTask", "PortaSpeechTaskConfig", "SEDTask",
           "SEDTaskConfig", "SeparationTask", "SeparationTaskConfig",
           "VAETask",
           "VAETaskConfig", "VISingerTask", "VISingerTaskConfig",
           "VocoderGANTask", "VocoderGANTaskConfig"]
