"""The TTS data path of the port against the JAX package's on the CPU: the
token-budget batching and its bucket ladder, the TTS loader's batch stream
over two epochs, the vocoder crops, the f0 tracker and the CWT targets,
TextGrid alignment, the wav processors, and the binarizer's records and
sidecars on the same seeded items."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.data import batching as jbatching
from audiogpt_tpu.data import binarizer as jbinarizer
from audiogpt_tpu.data import loader as jloader
from audiogpt_tpu.data import textgrid as jtextgrid
from audiogpt_tpu.data import wav_processors as jwp
from audiogpt_tpu.dsp import f0 as jf0
from audiogpt_tpu_torch.data import batching, binarizer, loader, textgrid
from audiogpt_tpu_torch.data import wav_processors as wp
from audiogpt_tpu_torch.dsp import f0
from test_textgrid import INTERVALS, PHONES, _tg

SR, HOP = 22050, 256
#: the f0 tracker's argmax over an FFT autocorrelation: a near-tie of two
#: lags may resolve to the other one in torch (frames that may differ, as a
#: share), and the parabolic refinement differs in float rounding (Hz)
F0_FRAME_SHARE, F0_HZ_ATOL = 0.01, 1e-2
#: the log-mel of the same wav through torch's and XLA's FFT (log10 units)
MEL_ATOL = 1e-4


def harmonic(seconds, f_base, seed, sr=SR):
    """A seeded voice-like signal: a moving f0 with two harmonics and noise,
    a quiet (unvoiced) head."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f = f_base + 0.2 * f_base * np.sin(2 * np.pi * 1.5 * t)
    ph = 2 * np.pi * np.cumsum(f) / sr
    wav = 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph) + 0.01 * rng.normal(size=n)
    wav[:1500] = 0.001 * rng.normal(size=1500)
    return wav.astype(np.float32), f


def tts_records(n=24, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        frames = int(rng.integers(20, 300))
        toks = int(rng.integers(5, 60))
        recs.append({"len": frames,
                     "tokens": rng.integers(3, 40, toks).astype(np.int32),
                     "mel": rng.normal(size=(frames, 8)).astype(np.float32),
                     "f0": rng.uniform(0, 300, frames).astype(np.float32),
                     "mel2ph": np.sort(rng.integers(1, toks + 1, frames))
                     .astype(np.int32),
                     "wav": rng.normal(size=frames * 16).astype(np.float32),
                     "spk_id": int(rng.integers(0, 3))})
    return recs


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- batching -----------------------------------------------------------------

@pytest.mark.parametrize("seed,max_tokens,max_sentences", [
    (0, 600, 8), (1, 2000, 100), (2, 900, 5), (3, None, 3)])
def test_batch_by_size_and_ordered_indices_match_jax(seed, max_tokens,
                                                     max_sentences):
    sizes = np.random.default_rng(seed).integers(10, 300, 57)
    for shuffle in (True, False):
        idx = batching.ordered_indices(sizes, shuffle=shuffle, seed=(seed, 3))
        ref = jbatching.ordered_indices(sizes, shuffle=shuffle, seed=(seed, 3))
        np.testing.assert_array_equal(idx, ref)
    got = batching.batch_by_size(idx, lambda i: int(sizes[i]), max_tokens,
                                 max_sentences)
    assert got == jbatching.batch_by_size(idx, lambda i: int(sizes[i]),
                                          max_tokens, max_sentences)
    with pytest.raises(ValueError):
        batching.batch_by_size([0], lambda i: 10, max_tokens=5)


def test_bucket_spec_and_endless_sampler_match_jax():
    for args in ((2048, 64, 128, 8), (128, 8, 128, 8), (500, 6, 32, 1)):
        spec = batching.BucketSpec.dyadic(*args)
        ref = jbatching.BucketSpec.dyadic(*args)
        assert (spec.length_buckets, spec.batch_buckets) == \
            (ref.length_buckets, ref.batch_buckets)
        for n in (1, 7, 8, 100, 129, 3000):
            assert spec.round_len(n) == ref.round_len(n)
            assert spec.round_batch(n) == ref.round_batch(n)
    # base.yaml's ladder: lengths 128–2048, batches 8–64
    spec = batching.BucketSpec.dyadic(2048, 64, min_batch=8)
    assert spec.length_buckets == (128, 256, 512, 1024, 2048)
    assert spec.batch_buckets == (8, 16, 32, 64)
    it, ir = iter(batching.EndlessSampler(11, seed=4)), \
        iter(jbatching.EndlessSampler(11, seed=4))
    got = [next(it) for _ in range(44)]
    assert got == [next(ir) for _ in range(44)]
    # each epoch is a permutation of its own
    assert all(sorted(got[i:i + 11]) == list(range(11))
               for i in range(0, 44, 11))
    assert got[:11] != got[11:22]


def test_tts_loader_gives_jax_batch_stream_over_two_epochs():
    """The same records through both loaders at a dyadic ladder: equal
    batches (every array, dtype and pad) over two epochs; each shape on the
    ladder, the dummy rows weight 0."""
    recs = tts_records()
    spec_args = (256, 8, 32, 2)
    kw = dict(max_tokens=900, max_sentences=6, seed=7)
    port = loader.TTSDataLoader(recs, spec=batching.BucketSpec.dyadic(
        *spec_args), **kw)
    ref = jloader.TTSDataLoader(recs, spec=jbatching.BucketSpec.dyadic(
        *spec_args), **kw)
    n = len(port.batches_for_epoch(0)) + len(port.batches_for_epoch(1))
    assert n == len(ref.batches_for_epoch(0)) + len(ref.batches_for_epoch(1))
    it_p, it_r = iter(port), iter(ref)
    spec = port.spec
    for _ in range(n):
        a, b = next(it_p), next(it_r)
        assert_batches_equal(a, b)
        bsz, length = a["mels"].shape[:2]
        assert bsz in spec.batch_buckets and length in spec.length_buckets
        real = int(a["weight"].sum())
        assert (a["weight"][real:] == 0).all() and (a["mels"][real:] == 0).all()
    # the validation pass (no shuffle); sizes given up front
    val = list(loader.TTSDataLoader(recs, shuffle=False, spec=spec,
                                    **kw).epoch(0))
    val_ref = list(jloader.TTSDataLoader(recs, shuffle=False, spec=ref.spec,
                                         **kw).epoch(0))
    for a, b in zip(val, val_ref, strict=True):
        assert_batches_equal(a, b)
    sizes = np.asarray([r["len"] for r in recs], np.int64)
    given = loader.TTSDataLoader(recs, sizes=sizes, **kw)
    assert all(given.batches_for_epoch(e) == port.batches_for_epoch(e)
               for e in (0, 1))
    with pytest.raises(ValueError):
        loader.TTSDataLoader(recs, sizes=sizes[:-1], **kw)


def test_collate_tts_word_fields_and_graph_match_jax():
    rng = np.random.default_rng(3)
    recs = []
    for toks, words, frames in ((7, 3, 30), (11, 5, 41)):
        recs.append({"tokens": rng.integers(3, 40, toks).astype(np.int32),
                     "mel": rng.normal(size=(frames, 4)).astype(np.float32),
                     "word_tokens": rng.integers(3, 9, words).astype(np.int32),
                     "ph2word": np.sort(rng.integers(1, words + 1, toks)),
                     "graph_adj": (rng.random((6, words, words)) > 0.5)
                     .astype(np.float32),
                     "cwt_spec": rng.normal(size=(frames, 10))
                     .astype(np.float32),
                     "f0_mean": 5.0, "f0_std": 0.2,
                     "spk_embed": rng.normal(size=16).astype(np.float32),
                     "energy": rng.random(frames).astype(np.float32)})
    spec = batching.BucketSpec.dyadic(64, 4, 8, 4)
    a = loader.collate_tts(recs, spec)
    b = jloader.collate_tts(recs, jbatching.BucketSpec.dyadic(64, 4, 8, 4), 4)
    assert_batches_equal(a, b)
    assert a["graph_adj"].shape == (4, 6, 8, 8)


def test_vocoder_crops_match_jax_from_the_same_seed():
    recs = tts_records(10, seed=2)
    a = loader.collate_vocoder(recs[:5], 32, 16, np.random.default_rng(5))
    b = jloader.collate_vocoder(recs[:5], 32, 16, np.random.default_rng(5))
    assert_batches_equal(a, b)
    port = iter(loader.VocoderDataLoader(recs, 24, 16, batch_size=4, seed=3))
    ref = iter(jloader.VocoderDataLoader(recs, 24, 16, batch_size=4, seed=3))
    for _ in range(6):                      # past one epoch of 10 records
        a = next(port)
        assert_batches_equal(a, next(ref))
        assert a["mels"].shape == (4, 24, 8) and a["wav"].shape == (4, 384)


# -- f0 and the CWT targets ---------------------------------------------------

def test_estimate_f0_matches_jax_frame_by_frame():
    """A seeded harmonic signal with a moving f0 (and a near-silent head):
    voiced decisions equal on all but ``F0_FRAME_SHARE`` of the frames, f0
    within ``F0_HZ_ATOL`` Hz on the rest; on a pure sine of 220 Hz the
    voiced frames sit on its pitch."""
    wav, _ = harmonic(2.0, 160.0, 0)
    batch = np.stack([wav, harmonic(2.0, 240.0, 1)[0]])
    got, uv = f0.estimate_f0(torch.from_numpy(batch))
    for row in range(2):
        ref, ref_uv = jf0.estimate_f0(jnp.asarray(batch[row]))
        ref, ref_uv = np.asarray(ref), np.asarray(ref_uv)
        assert got.shape[-1] == ref.shape[0] == -(-batch.shape[1] // HOP)
        a, u = got[row].numpy(), uv[row].numpy()
        differ = (np.abs(a - ref) > F0_HZ_ATOL) | (u != ref_uv)
        assert differ.mean() <= F0_FRAME_SHARE, np.flatnonzero(differ)
        assert ref_uv.sum() > 0.8 * len(ref_uv) and ref_uv[:4].sum() == 0
    t = np.arange(SR) / SR
    sine = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    hz, voiced = f0.estimate_f0(torch.from_numpy(sine))
    mid = hz[4:-4][voiced[4:-4] > 0]
    assert len(mid) > 70 and (mid - 220.0).abs().max() < 2.0


def test_f0_targets_and_cwt_match_jax():
    rng = np.random.default_rng(4)
    track = rng.uniform(80, 400, 180)
    track[[0, 1, 50, 51, 52, 179]] = 0.0
    np.testing.assert_array_equal(f0.f0_to_coarse(track),
                                  jf0.f0_to_coarse(track))
    for a, b in zip(f0.continuous_lf0(track), jf0.continuous_lf0(track)):
        np.testing.assert_array_equal(a, b)
    uv, lf0 = f0.continuous_lf0(track)
    W, scales = f0.cwt_lf0(lf0 - lf0.mean())
    W_ref, scales_ref = jf0.cwt_lf0(lf0 - lf0.mean())
    np.testing.assert_allclose(W, W_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(scales, scales_ref)
    for a, b in zip(f0.norm_scale(W), jf0.norm_scale(W_ref)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert W.shape == (180, 10)


# -- TextGrid alignment --------------------------------------------------------

def test_textgrid_cases_match_jax():
    tg = _tg(INTERVALS)
    assert textgrid.parse_textgrid(tg) == jtextgrid.parse_textgrid(tg)
    for phones, intervals in ((PHONES, INTERVALS),
                              (["<BOS>", "HH", ",", "AH0", "L", "OW1",
                                "<EOS>"], INTERVALS)):
        got = textgrid.mel2ph_from_textgrid(_tg(intervals), phones, 87, SR,
                                            HOP)
        ref = jtextgrid.mel2ph_from_textgrid(_tg(intervals), phones, 87, SR,
                                             HOP)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    mel2ph, dur = textgrid.mel2ph_from_textgrid(tg, PHONES, 87, SR, HOP)
    assert mel2ph[int(0.10 * SR / HOP + 0.5)] == 2 and dur.sum() == 87
    with pytest.raises(ValueError, match="mismatch"):
        textgrid.mel2ph_from_textgrid(tg, PHONES[:-2] + ["<EOS>"], 87, SR,
                                      HOP)
    assert [textgrid.is_sil_phoneme(p) for p in PHONES] == \
        [jtextgrid.is_sil_phoneme(p) for p in PHONES]


# -- wav processors -----------------------------------------------------------

def test_wav_processors_match_jax():
    """``tests/test_data.py``'s pipeline cases against JAX's processors:
    trim, long-silence capping and loudness equal; the resampler within
    float rounding; an unknown name raises."""
    sr = 16000
    rng = np.random.default_rng(0)
    speech = rng.normal(size=sr).astype(np.float32) * 0.3
    pad = np.zeros(sr, np.float32)
    wav = np.concatenate([pad, speech, pad, pad, pad, speech, pad])
    for names in (["trim_sil"], ["trim_long_sil"], ["loudness_norm"],
                  ["trim_sil", "loudness_norm"]):
        got, got_sr = wp.apply_processors(names, wav, sr)
        ref, ref_sr = jwp.apply_processors(names, wav, sr)
        assert got_sr == ref_sr and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    out, _ = wp.apply_processors(["trim_long_sil"], wav, sr)
    assert len(out) < len(wav) - sr
    opts = {"resample": {"target_sr": 8000}}
    got, got_sr = wp.apply_processors(
        ["resample"], wav, sr, {"resample": {**opts["resample"],
                                             "device": "cpu"}})
    ref, _ = jwp.apply_processors(["resample"], wav, sr, opts)
    assert got_sr == 8000 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    with pytest.raises(KeyError):
        wp.apply_processors(["nope"], wav, sr)
    assert set(wp.WAV_PROCESSORS) == set(jwp.WAV_PROCESSORS)


# -- the binarizer -------------------------------------------------------------

TEXTS = ("hello world, this is a test.", "the quick brown fox",
         "jumps over the lazy dog!", "printing, in the only sense")


def items(module, n=5):
    """``n`` seeded items at two lengths (one JAX compile each), two
    speakers; the last carries explicit durations."""
    out = []
    for i in range(n):
        wav, _ = harmonic(1.0 + 0.25 * (i % 2), 140.0 + 25 * i, i)
        kw = {}
        if i == n - 1:
            frames = 1 + len(wav) // HOP
            phones = ["HH", "AH0", "L", "OW1"]
            kw = dict(phones=phones, durations=[frames // 4] * 3
                      + [frames - 3 * (frames // 4)])
        out.append(module.Item(name=f"u{i}", wav=wav, spk=f"s{i % 2}",
                               text=TEXTS[i % 4], **kw))
    return out


@pytest.fixture(scope="module")
def binarized(tmp_path_factory):
    root = tmp_path_factory.mktemp("bin")
    kw = dict(with_f0=True, with_f0cwt=True, with_energy=True, with_wav=True,
              with_words=True, with_graph=True, valid_fraction=0.25)
    jbinarizer.TTSBinarizer(jbinarizer.BinarizeConfig(**kw)).binarize(
        items(jbinarizer), str(root / "jax"))
    counts = binarizer.TTSBinarizer(binarizer.BinarizeConfig(**kw),
                                    device="cpu").binarize(
        items(binarizer), str(root / "port"))
    return root, counts


def test_binarizer_writes_jax_records(binarized):
    """Every field of every record: ids, alignments, lengths, word fields
    and graphs equal; the mel within ``MEL_ATOL``; f0 as in the tracker's
    test; the CWT targets and statistics from those f0 tracks."""
    root, counts = binarized
    assert counts == {"test": 0, "valid": 1, "train": 4}
    for split in ("train", "valid"):
        port = binarizer.load_split(str(root / "port"), split)
        ref = jbinarizer.load_split(str(root / "jax"), split)
        assert len(port) == len(ref) == counts[split]
        for i in range(len(ref)):
            a, b = port[i], ref[i]
            assert sorted(a) == sorted(b)
            for key in ("tokens", "pitch", "mel2ph", "word_tokens",
                        "ph2word", "graph_adj", "wav"):
                if key in b:
                    np.testing.assert_array_equal(a[key], b[key], key)
            for key in ("item_name", "txt", "ph", "spk_id", "len", "sec"):
                assert a[key] == b[key], key
            np.testing.assert_allclose(a["mel"], b["mel"], atol=MEL_ATOL)
            differ = np.abs(a["f0"] - b["f0"]) > F0_HZ_ATOL
            assert differ.mean() <= F0_FRAME_SHARE
            if not differ.any():
                np.testing.assert_allclose(a["cwt_spec"], b["cwt_spec"],
                                           atol=1e-3)
                assert abs(a["f0_mean"] - b["f0_mean"]) < 1e-6
            np.testing.assert_allclose(a["energy"], b["energy"], rtol=1e-3)
    for name in ("phone_set.json", "spk_map.json", "word_set.json"):
        with open(root / "port" / name) as f, open(root / "jax" / name) as g:
            assert json.load(f) == json.load(g), name
    for name in ("train_lengths.npy", "valid_lengths.npy",
                 "test_lengths.npy"):
        np.testing.assert_array_equal(np.load(root / "port" / name),
                                      np.load(root / "jax" / name))
    np.testing.assert_allclose(np.load(root / "port" /
                                       "train_f0s_mean_std.npy"),
                               np.load(root / "jax" /
                                       "train_f0s_mean_std.npy"), rtol=1e-5)
    rec = binarizer.load_split(str(root / "port"), "train")[3]
    np.testing.assert_array_equal(rec["mel2ph"], binarizer
                                  .mel2ph_from_durations(
                                      np.bincount(rec["mel2ph"])[1:],
                                      rec["len"]))
    enc = binarizer.load_phone_encoder(str(root / "port"))
    assert enc.encode(rec["ph"].split(" ")) == rec["tokens"].tolist()
    assert len(binarizer.load_word_encoder(str(root / "port"))) > 3


def test_binarizer_style_embeds_and_textgrid_match_jax(tmp_path):
    """``with_style_embed`` with the JAX encoder's params passed across
    (``style_params``: the port's own default weights differ from JAX's
    default init); an item aligned by a TextGrid gets JAX's ``mel2ph`` and
    ``dur``."""
    import jax

    from audiogpt_tpu.models.tts.generspeech import GlobalStyleEncoder
    from test_torch_t2a import _random_params

    params = _random_params(jax.eval_shape(
        GlobalStyleEncoder().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, 80))), seed=3)
    wav = (np.random.default_rng(0).normal(size=SR) * 0.1).astype(np.float32)
    cfg = dict(with_f0=False, with_style_embed=True, valid_fraction=0.0)
    jbinarizer.TTSBinarizer(jbinarizer.BinarizeConfig(**cfg),
                            style_params=params).binarize(
        [jbinarizer.Item("a", wav, phones=PHONES, textgrid=_tg(INTERVALS))],
        str(tmp_path / "jax"))
    binarizer.TTSBinarizer(binarizer.BinarizeConfig(**cfg),
                           style_params=params, device="cpu").binarize(
        [binarizer.Item("a", wav, phones=PHONES, textgrid=_tg(INTERVALS))],
        str(tmp_path / "port"))
    a = binarizer.load_split(str(tmp_path / "port"), "train")[0]
    b = jbinarizer.load_split(str(tmp_path / "jax"), "train")[0]
    for key in ("spk_embed", "emo_embed"):
        assert a[key].shape == (256,)
        np.testing.assert_allclose(a[key], b[key], atol=1e-4)
    for key in ("mel2ph", "dur"):
        np.testing.assert_array_equal(a[key], b[key])


def test_items_from_csv_and_wav_processors_in_the_binarizer(tmp_path):
    paths = {}
    for n in ("a1", "a2"):
        paths[n] = str(tmp_path / f"{n}.npy")
        np.save(paths[n], np.zeros(100, np.float32))
    csv_path = tmp_path / "metadata_phone.csv"
    csv_path.write_text(
        "item_name,txt,ph,wav_fn,spk_name,others\n"
        f'a1,hello,HH AH0 L OW1,{paths["a1"]},spkA,"Happy"\n'
        f'a2,world,W ER1 L D,{paths["a2"]},,\n')
    got = binarizer.items_from_csv(str(csv_path), wav_loader=np.load)
    ref = jbinarizer.items_from_csv(str(csv_path), wav_loader=np.load)
    for a, b in zip(got, ref, strict=True):
        for key in ("name", "text", "phones", "spk", "emotion", "textgrid"):
            assert getattr(a, key) == getattr(b, key)
    rng = np.random.default_rng(0)
    speech = rng.normal(size=SR // 2).astype(np.float32) * 0.2
    wav = np.concatenate([np.zeros(SR, np.float32), speech,
                          np.zeros(SR, np.float32)])
    cfg = binarizer.BinarizeConfig(with_f0=False,
                                   wav_processors=("trim_sil",
                                                   "loudness_norm"))
    binarizer.TTSBinarizer(cfg, device="cpu").binarize(
        [binarizer.Item(f"u{i}", wav, text="hello world") for i in range(4)],
        str(tmp_path / "bin"))
    rec = binarizer.load_split(str(tmp_path / "bin"), "train")[0]
    assert rec["mel"].shape[0] < (len(wav) / HOP) * 0.7
    assert os.path.exists(tmp_path / "bin" / "valid.idx")
