"""Data pipeline: the record store, batching, the TTS, SVS, Mandarin and
emotion binarizers and the host loaders (counterpart of
``audiogpt_tpu/data``, the parts the ported recipes use). ``audioset_labels.csv`` beside these modules is the SED engines'
label table."""

from audiogpt_tpu_torch.data.batching import (BucketSpec, EndlessSampler,
                                              batch_by_size, collate_1d,
                                              collate_2d, ordered_indices)
from audiogpt_tpu_torch.data.binarizer import (BinarizeConfig,
                                               EmotionBinarizer, Item,
                                               SVSBinarizer, SVSItem,
                                               TTSBinarizer, ZhBinarizer,
                                               items_from_csv, load_emo_map,
                                               load_phone_encoder,
                                               load_split, load_word_encoder,
                                               mel2ph_from_durations)
from audiogpt_tpu_torch.data.loader import (ArrayDataLoader, TTSDataLoader,
                                            VocoderDataLoader,
                                            collate_audio_text,
                                            collate_mel_image,
                                            collate_mixture,
                                            collate_motion, collate_tagging,
                                            collate_tts,
                                            collate_vocoder, prefetch)
from audiogpt_tpu_torch.data.records import RecordDataset, RecordWriter
from audiogpt_tpu_torch.data.textgrid import (is_sil_phoneme,
                                              mel2ph_from_textgrid,
                                              parse_textgrid)

__all__ = [
    "BucketSpec", "EndlessSampler", "batch_by_size", "collate_1d",
    "collate_2d", "ordered_indices", "BinarizeConfig", "EmotionBinarizer",
    "Item", "SVSBinarizer", "SVSItem", "TTSBinarizer", "ZhBinarizer",
    "items_from_csv", "load_emo_map",
    "load_phone_encoder", "load_split",
    "load_word_encoder", "mel2ph_from_durations", "ArrayDataLoader",
    "TTSDataLoader", "VocoderDataLoader", "collate_audio_text",
    "collate_mel_image", "collate_mixture", "collate_motion",
    "collate_tagging", "collate_tts", "collate_vocoder",
    "prefetch",
    "RecordDataset", "RecordWriter",
    "is_sil_phoneme", "mel2ph_from_textgrid", "parse_textgrid",
]
