from audiogpt_tpu_torch.models.tts.fastspeech2 import (  # noqa: F401
    FastSpeech2, FastSpeech2Config)
from audiogpt_tpu_torch.models.tts.portaspeech import (  # noqa: F401
    PortaSpeech, PortaSpeechConfig)
