from audiogpt_tpu_torch.engines.base import Bucketer, resolve_device  # noqa: F401
from audiogpt_tpu_torch.engines.t2a import T2AConfig, T2AEngine  # noqa: F401
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine  # noqa: F401
from audiogpt_tpu_torch.engines.asr import ASREngine  # noqa: F401
from audiogpt_tpu_torch.engines.tts import (  # noqa: F401
    PortaSpeechTTSEngine,
    TTSEngine,
)
from audiogpt_tpu_torch.engines.i2a import I2AEngine  # noqa: F401
from audiogpt_tpu_torch.engines.t2i import T2IConfig, T2IEngine  # noqa: F401
from audiogpt_tpu_torch.engines.analysis import (  # noqa: F401
    CaptionEngine,
    ImageCaptionEngine,
    SEDEngine,
    TSDEngine,
)
from audiogpt_tpu_torch.engines.transform import (  # noqa: F401
    BinauralEngine,
    ExtractionEngine,
    SeparationEngine,
)
from audiogpt_tpu_torch.engines.svs import SVSEngine, VISingerEngine  # noqa: F401
from audiogpt_tpu_torch.engines.tts_ood import StyleTransferEngine  # noqa: F401
from audiogpt_tpu_torch.engines.face import GeneFaceEngine  # noqa: F401
