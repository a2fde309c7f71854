from audiogpt_tpu_torch.models.asr.whisper import (  # noqa: F401
    WhisperConfig,
    WhisperDecoder,
    WhisperEncoder,
    WhisperModel,
    decode,
    prime,
    whisper_log_mel,
)
