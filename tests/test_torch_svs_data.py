"""The SVS, Mandarin, motion and audio-text data paths of the port against
the JAX package's on the CPU: ``SVSBinarizer`` and ``ZhBinarizer`` records
on the same seeded items (the score alignment's round half to even, the
slur repeats; the Mandarin frontend and both duration rules, a separator
kept and one collapsed), ``collate_tts`` with the score fields, the linear
spec and the sample-level wav on a bucketed batch with padded rows, the
VISinger loader stream, ``collate_motion`` with and without video targets,
``collate_audio_text`` in both schemas; then ``train_cli`` training one
step of each new recipe from the repo's config files, and the three
analysis recipes still refused."""

import json
import os

import numpy as np
import pytest

from audiogpt_tpu.data import batching as jbatching
from audiogpt_tpu.data import binarizer as jbinarizer
from audiogpt_tpu.data import loader as jloader
from audiogpt_tpu.dsp import mel as jmel
from audiogpt_tpu.text import zh as jzh
from audiogpt_tpu_torch import train_cli
from audiogpt_tpu_torch.data import RecordWriter, batching, binarizer, loader
from audiogpt_tpu_torch.dsp import mel
from audiogpt_tpu_torch.text import zh
from test_torch_tts_data import (F0_FRAME_SHARE, F0_HZ_ATOL, MEL_ATOL,
                                 assert_batches_equal, harmonic)
from test_train_cli import CASES, _write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000

#: opencpop-style scores: pinyin words, '|' note windows (a slur is a
#: second note in a window), durations in seconds; 0.4 s over two phones
#: is 37.5 frames at hop 128 (rounds to 38, half to even)
SCORES = (
    ("xiao jiu wo", "C#4/Db4 | F#4/Gb4 | G#4/Ab4 A4",
     "0.4071 | 0.4 | 0.2421 0.216"),
    ("ni hao SP", "A4 | B4 | rest", "0.3 | 0.3 | 0.1"),
    ("AP wo ai ni", "rest | E4 | D4 F4 | C4", "0.2 | 0.4 | 0.32 0.2 | 0.4"),
)


def assert_records_equal(a, b, f0=True):
    """Every field: integers, strings and the score floats exactly; the
    mel within ``MEL_ATOL`` (the two FFTs); f0 as the tracker's test
    holds it."""
    assert sorted(a) == sorted(b)
    for key, va in a.items():
        vb = b[key]
        if key == "mel":
            np.testing.assert_allclose(va, vb, atol=MEL_ATOL)
        elif key in ("f0", "pitch"):
            continue
        elif isinstance(va, np.ndarray):
            assert va.dtype == np.asarray(vb).dtype, key
            np.testing.assert_array_equal(va, vb, err_msg=key)
        else:
            assert va == vb, key
    if f0:
        differ = np.abs(a["f0"] - b["f0"]) > F0_HZ_ATOL
        assert differ.mean() <= F0_FRAME_SHARE
        np.testing.assert_array_equal(a["pitch"][~differ],
                                      b["pitch"][~differ])


def svs_items(module, n=6):
    out = []
    for i in range(n):
        text, notes, durs = SCORES[i % len(SCORES)]
        sec = sum(float(d) for w in durs.split("|") for d in w.split())
        wav, _ = harmonic(sec, 200.0 + 20 * i, i, sr=SR)
        out.append(module.SVSItem(name=f"s{i}", wav=wav, text=text,
                                  notes=notes, notes_duration=durs,
                                  spk=f"singer{i % 2}"))
    return out


@pytest.mark.parametrize("hop", [128, 256])
def test_svs_binarizer_writes_jax_records(tmp_path, hop):
    """``opencpop.yaml``'s mel (hop 128) and the VISinger pass (hop 256,
    with the wav): the score fields, the phone set and sidecars, and
    ``mel2ph`` from the note durations, equal to JAX's."""
    kw = dict(with_f0=True, with_wav=hop == 256, valid_fraction=0.2)
    spec = mel.NEURALSEQ_MEL_24K if hop == 128 else \
        mel.MelSpec(SR, 1024, 256, 1024, 80, 30.0, 12000.0, power=1.0,
                    pad_mode="constant", log="log10", amin=1e-5)
    jspec = jmel.NEURALSEQ_MEL_24K if hop == 128 else \
        jmel.MelSpec(SR, 1024, 256, 1024, 80, 30.0, 12000.0, power=1.0,
                     pad_mode="constant", log="log10", amin=1e-5)
    counts = binarizer.SVSBinarizer(binarizer.BinarizeConfig(
        mel=spec, **kw), device="cpu").binarize(svs_items(binarizer),
                                                str(tmp_path / "port"))
    ref_counts = jbinarizer.SVSBinarizer(jbinarizer.BinarizeConfig(
        mel=jspec, **kw)).binarize(svs_items(jbinarizer),
                                   str(tmp_path / "jax"))
    assert counts == ref_counts == {"test": 0, "valid": 1, "train": 5}
    for split in ("train", "valid"):
        port = binarizer.load_split(str(tmp_path / "port"), split)
        ref = jbinarizer.load_split(str(tmp_path / "jax"), split)
        for i in range(len(ref)):
            assert_records_equal(port[i], ref[i])
    for name in ("phone_set.json", "spk_map.json"):
        with open(tmp_path / "port" / name) as f, \
                open(tmp_path / "jax" / name) as g:
            assert json.load(f) == json.load(g), name
    rec = binarizer.load_split(str(tmp_path / "port"), "train")[1]
    assert rec["is_slur"].tolist().count(1) == 1
    assert rec["pitch_midi"].max() > 40 and rec["pitch_midi"][0] == 0
    if hop == 128:
        # "xiao": 0.4071 s over two phones; "jiu": 37.5 → 38 frames a phone
        first = binarizer.load_split(str(tmp_path / "port"), "valid")[0]
        assert np.bincount(first["mel2ph"])[3:5].tolist() == [38, 38]


def test_zh_duration_rules_match_jax():
    """Rule 1 keeps a separator of ≥ 100 frames after its leading voiced
    frames go to the final, and collapses a shorter one into it; rule 2
    splits an initial and its final evenly (``total // 2`` first); the
    cases of the JAX package's own test and a longer sentence."""
    port = binarizer.ZhBinarizer(binarizer.BinarizeConfig(), device="cpu")
    ref = jbinarizer.ZhBinarizer(jbinarizer.BinarizeConfig())
    phones = ["x", "iao3", "|"]
    voiced = np.concatenate([np.full(35, 200.0), np.zeros(115)])
    cases = [(phones, [10, 20, 120], voiced),
             (phones, [10, 20, 60], np.concatenate([np.full(30, 200.0),
                                                    np.zeros(60)])),
             (["n", "i3", "|", "h", "ao3", ",", "sh", "i4", "j", "ie4", "."],
              [7, 30, 4, 9, 41, 130, 11, 28, 5, 33, 90],
              np.where((np.arange(388) // 37) % 3 == 2, 0.0, 180.0))]
    for phs, dur, f0 in cases:
        got = port._fix_durations(np.asarray(dur), phs, f0)
        want = ref._fix_durations(np.asarray(dur), phs, f0)
        np.testing.assert_array_equal(got, want)
        assert got.sum() == sum(dur)
    kept = port._fix_durations(np.asarray([10, 20, 120]), phones, voiced)
    assert kept.tolist() == [17, 18, 115]
    collapsed = port._fix_durations(np.asarray([10, 20, 60]), phones,
                                    cases[1][2])
    assert collapsed.tolist() == [45, 45, 0]


def test_zh_frontend_and_binarizer_match_jax(tmp_path):
    """Hanzi (a number, a polyphone in a phrase, punctuation) and pinyin
    through both ``ZhTTSFrontend``s; aligned items (voiced sines with a
    quiet pause, so both trackers agree) through both ``ZhBinarizer``s:
    records equal, ``dur`` and ``mel2ph`` after the two rules."""
    texts = ("你好，世界。", "音乐让我快乐，我有2个苹果！", "ni3 hao3 shi4 jie4")
    for text in texts:
        a, b = zh.ZhTTSFrontend()(text), jzh.ZhTTSFrontend()(text)
        assert (a.text, a.words, a.phones, a.ph2word) == \
            (b.text, b.words, b.phones, b.ph2word)
    assert zh.ZhFrontend()(texts[1]) == jzh.ZhFrontend()(texts[1])

    hop, sr = 256, 22050

    def items(module):
        out = []
        for i, text in enumerate(texts[:2] * 2):
            phones = zh.ZhTTSFrontend()(text).phones
            frames = 300 + 20 * i
            t = np.arange(frames * hop) / sr
            noise = np.random.default_rng(i).normal(size=len(t))
            wav = 0.3 * np.sin(2 * np.pi * (170 + 10 * i) * t) \
                + 0.01 * noise
            # a quiet pause of 120 frames
            wav[120 * hop:240 * hop] = 0.001 * noise[120 * hop:240 * hop]
            dur = np.full(len(phones), (frames + 1) // len(phones))
            dur[-1] = frames + 1 - dur[:-1].sum()
            out.append(module.Item(f"zh{i}", wav.astype(np.float32),
                                   text=text, durations=dur.tolist()))
        return out

    cfg = dict(with_f0=True, valid_fraction=0.25)
    binarizer.ZhBinarizer(binarizer.BinarizeConfig(**cfg),
                          device="cpu").binarize(items(binarizer),
                                                 str(tmp_path / "port"))
    jbinarizer.ZhBinarizer(jbinarizer.BinarizeConfig(**cfg)).binarize(
        items(jbinarizer), str(tmp_path / "jax"))
    for split in ("train", "valid"):
        port = binarizer.load_split(str(tmp_path / "port"), split)
        ref = jbinarizer.load_split(str(tmp_path / "jax"), split)
        assert len(port) == len(ref) > 0
        for i in range(len(ref)):
            np.testing.assert_array_equal(port[i]["f0"] > 0, ref[i]["f0"] > 0)
            assert_records_equal(port[i], ref[i])
            assert port[i]["dur"].sum() == port[i]["len"]
    with open(tmp_path / "port" / "phone_set.json") as f, \
            open(tmp_path / "jax" / "phone_set.json") as g:
        assert json.load(f) == json.load(g)


# -- the collates ---------------------------------------------------------------

def score_records(n=5, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        frames, toks = int(rng.integers(20, 90)), int(rng.integers(4, 20))
        recs.append({
            "len": frames, "tokens": rng.integers(3, 40, toks).astype(np.int32),
            "mel": rng.normal(size=(frames, 8)).astype(np.float32),
            "f0": rng.uniform(0, 300, frames).astype(np.float32),
            "mel2ph": np.sort(rng.integers(1, toks + 1, frames)
                              ).astype(np.int32),
            "pitch_midi": rng.integers(40, 80, toks).astype(np.int32),
            "midi_dur": rng.uniform(0.1, 0.5, toks).astype(np.float32),
            "is_slur": (rng.random(toks) < 0.3).astype(np.int32),
            "spec": rng.random((frames, 33)).astype(np.float32),
            # a wav one hop short of the frames, another longer
            "wav": rng.normal(size=frames * 16 + int(rng.integers(-16, 40))
                              ).astype(np.float32),
            "spk_id": int(rng.integers(0, 3))})
    return recs


def test_collate_tts_score_fields_spec_and_wav_match_jax():
    """Five records on a (128, 8) rung: three padded rows of weight 0, the
    score fields on the token axis (``midi_dur`` float32), the spec on the
    mel's, the wav cut or padded to ``mel_len · 16``; and without
    ``wav_hop`` no wav."""
    recs = score_records()
    spec = batching.BucketSpec.dyadic(128, 8, 32, 8)
    jspec = jbatching.BucketSpec.dyadic(128, 8, 32, 8)
    got = loader.collate_tts(recs, spec, wav_hop=16)
    ref = jloader.collate_tts(recs, jspec, 8, wav_hop=16)
    assert_batches_equal(got, ref)
    assert got["txt_tokens"].shape[0] == 8 and got["weight"][5:].sum() == 0
    assert got["midi_dur"].dtype == np.float32
    assert got["wav"].shape[1] == got["mels"].shape[1] * 16
    plain = loader.collate_tts(recs, spec)
    assert "wav" not in plain
    assert_batches_equal(plain, jloader.collate_tts(recs, jspec, 8))


def test_visinger_loader_stream_matches_jax():
    """The token-budget loader with VISinger's collate (``wav_hop``) gives
    JAX's batches over two epochs."""
    import functools

    recs = score_records(n=14, seed=3)
    kw = dict(max_tokens=300, max_sentences=4, seed=5)
    got = loader.TTSDataLoader(
        recs, spec=batching.BucketSpec.dyadic(128, 4, 32, 2),
        collate_fn=functools.partial(loader.collate_tts, wav_hop=16), **kw)
    ref = jloader.TTSDataLoader(
        recs, spec=jbatching.BucketSpec.dyadic(128, 4, 32, 2), n_mels=8,
        collate_fn=functools.partial(jloader.collate_tts, wav_hop=16), **kw)
    for e in (0, 1):
        a, b = list(got.epoch(e)), list(ref.epoch(e))
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            assert_batches_equal(x, y)


def test_collate_motion_and_audio_text_match_jax():
    """``collate_motion``: a record with video-derived motion (cut) and two
    without (the pseudo-target of the padded mel; one longer than
    ``mel_len``, one shorter); ``collate_audio_text`` in the caption and
    CLAP schemas, clips and texts cut and padded."""
    rng = np.random.default_rng(4)
    recs = [{"mel": rng.random((80, 16)).astype(np.float32),
             "motion": rng.normal(size=(40, 136)).astype(np.float32)},
            {"mel": rng.random((50, 16)).astype(np.float32)},
            {"mel": rng.random((70, 16)).astype(np.float32)}]
    got = loader.collate_motion(recs, mel_len=64, video_len=25)
    assert_batches_equal(got, jloader.collate_motion(recs, 64, 25))
    assert got["motion"].shape == (3, 25, 136)
    assert np.abs(got["motion"][1]).max() > 0
    clips = [{"wav": rng.normal(size=n).astype(np.float32),
              "tokens": rng.integers(1, 30, k).astype(np.int32),
              "text_ids": rng.integers(3, 200, k).astype(np.int32)}
             for n, k in ((1200, 5), (800, 12), (1000, 8))]
    for schema in ("caption", "clap"):
        got = loader.collate_audio_text(clips, 1000, 8, schema=schema)
        assert_batches_equal(got, jloader.collate_audio_text(
            clips, 1000, 8, schema=schema))
    assert got["wav_len"].tolist() == [1000, 800, 1000]


# -- the CLI --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["diffsinger", "visinger", "audio2motion",
                                  "vae", "clap"])
def test_train_cli_trains_the_new_recipes(name, tmp_path):
    """``train_cli.main`` with the repo's config file and the JAX CLI
    test's tiny hparams on its fixture records: one step on the CPU, every
    logged term finite, a checkpoint written; the two GAN recipes log
    both groups."""
    cfg_path, hp, make_records = CASES[name]
    bin_dir = str(tmp_path / "bin")
    recs = make_records()
    _write(os.path.join(bin_dir, "train"), recs)
    _write(os.path.join(bin_dir, "valid"), recs[:2])
    exp = str(tmp_path / "exp")
    hparams = (f"data.binary_dir={bin_dir}," + hp
               + ",num_sanity_val_steps=1,log_interval=1,"
               "val_check_interval=50,use_tensorboard=false")
    train_cli.main(["--config", os.path.join(REPO, cfg_path), "--exp_name",
                    exp, "--max_updates", "1", "--hparams", hparams,
                    "--device", "cpu"])
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    tr = [line for line in lines if line["prefix"] == "tr"]
    assert len(tr) == 1
    vals = {k: v for k, v in tr[0].items() if isinstance(v, float)}
    assert vals and all(np.isfinite(v) for v in vals.values()), vals
    assert any(line["prefix"] == "sanity" for line in lines)
    if name in ("visinger", "vae"):
        assert "d_loss" in vals and ("kl" in vals)
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["1.json",
                                                             "1.pt"]


@pytest.mark.parametrize("name", ["sed", "caption", "separation"])
def test_train_cli_still_refuses_the_analysis_recipes(name, tmp_path):
    """The analysis recipes are ported now: ``build_task`` builds each one's
    task and ``build_loaders`` its fixed-shape batches from the JAX CLI
    test's records; only an unknown task is still refused."""
    cfg_path, hp, make_records = CASES[name]
    bin_dir = str(tmp_path / "bin")
    _write(os.path.join(bin_dir, "train"), make_records())
    cfg = train_cli.load_config(os.path.join(REPO, cfg_path),
                                overrides=f"data.binary_dir={bin_dir}," + hp)
    task = train_cli.build_task(cfg, device="cpu")
    assert type(task).__name__ == {"sed": "SEDTask", "caption": "CaptionTask",
                                   "separation": "SeparationTask"}[name]
    batch = next(train_cli.build_loaders(cfg, name)[0])
    keys = {"sed": {"wav", "wav_len", "target", "weight"},
            "caption": {"wav", "wav_len", "tokens", "token_len", "weight"},
            "separation": {"mix", "sources", "weight"}}[name]
    assert set(batch) == keys
    assert not hasattr(train_cli, "_NOT_PORTED")
    with pytest.raises(ValueError, match="unknown task"):
        train_cli.build_task(train_cli.load_config(
            os.path.join(REPO, cfg_path), overrides="task=nope"),
            device="cpu")


def test_visinger_records_with_spec_feed_the_loader(tmp_path):
    """The record store round-trips the VISinger fields (``spec``,
    ``wav``) that the SVS binarizer's fixtures carry."""
    recs = score_records(n=3, seed=7)
    with RecordWriter(str(tmp_path / "train")) as w:
        for r in recs:
            w.add(r)
    ds = binarizer.load_split(str(tmp_path), "train")
    batch = loader.collate_tts([ds[i] for i in range(3)], None, wav_hop=16)
    np.testing.assert_array_equal(batch["spec"][0, :recs[0]["len"]],
                                  recs[0]["spec"])
