from audiogpt_tpu_torch.models.binaural.binaural import (  # noqa: F401
    BinauralConfig,
    BinauralNetwork,
    binauralize_chunked,
)
