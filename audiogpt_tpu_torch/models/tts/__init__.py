from audiogpt_tpu_torch.models.tts.fastspeech2 import (  # noqa: F401
    FastSpeech2, FastSpeech2Config)
