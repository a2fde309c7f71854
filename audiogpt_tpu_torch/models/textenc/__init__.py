from audiogpt_tpu_torch.models.textenc.bert import BertConfig, BertEncoder  # noqa: F401
from audiogpt_tpu_torch.models.textenc.clap import (  # noqa: F401
    CLAPAudioEncoder,
    CLAPScorer,
    CLAPTextConfig,
    CLAPTextEncoder,
    Projection,
    WordPieceTokenizer,
)
from audiogpt_tpu_torch.models.textenc.htsat import (  # noqa: F401
    HTSATAudioEncoder,
    HTSATConfig,
)
from audiogpt_tpu_torch.models.textenc.t5 import (  # noqa: F401
    T5Conditioner,
    T5Config,
    T5Encoder,
)
