"""PyTorch port vs JAX: the sequential Encoder and the gop-0 encode.

The port's `Encoder(device="cpu")` must write the bytes of the JAX
package's `Encoder` at the five settings of tests/test_encoder.py, with
`force_metadata` mid-GOP, and when it resumes from a JAX
`state_dict()` (and the JAX encoder from the port's). The port's
gop-0 `encode_stream_gops` must equal the JAX package's and the port's
own `Encoder`; its host ABR law equals the JAX law on Python ints.
Exact equality throughout; frames from numpy seeds (tests/corpus.py)."""

import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (RATE_CONTROL_ABR, RATE_CONTROL_CRF,
                                SUBSAMP_420, SUBSAMP_444, quality_percent)
from dsv1_tpu.models import encoder as jenc
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.parallel import encode_stream_gops
import dsv1_tpu_torch as dt
from dsv1_tpu_torch.models import encoder as tenc

from . import corpus

torch.set_num_threads(1)

qp = quality_percent


def _brighten(frames, cut_at):
    """A scene cut from frame cut_at on: luma brightened by 90, so the
    average-luma scene-change test fires."""
    return [(np.clip(y.astype(np.int32) + 90, 0, 255).astype(np.uint8)
             if i >= cut_at else y, u, v)
            for i, (y, u, v) in enumerate(frames)]


def _jax(meta, kw, frames):
    enc = jenc.Encoder(meta, jenc.EncoderConfig(**kw))
    enc.start()
    return enc.encode_stream(frames)


def _port(meta, kw, frames):
    enc = dt.Encoder(dt.Metadata(*vars(meta).values()),
                     dt.EncoderConfig(**kw), device="cpu")
    enc.start()
    return enc.encode_stream(frames)


# the settings of tests/test_encoder.py (the JAX encoder against the C
# reference), with scene cuts in the ABR and 4:4:4 clips
SETTINGS = {
    "gop0_crf": (96, 80, SUBSAMP_420, 4, -1, dict(
        quality=qp(70), gop=0, rc_mode=RATE_CONTROL_CRF, stable_refresh=1)),
    "gop6_crf": (96, 80, SUBSAMP_420, 8, -1, dict(
        quality=qp(70), gop=6, rc_mode=RATE_CONTROL_CRF, stable_refresh=5)),
    "abr_300k": (96, 80, SUBSAMP_420, 10, 3, dict(
        quality=qp(80) * 3 // 2, gop=6, rc_mode=RATE_CONTROL_ABR,
        bitrate=300 * 1024, stable_refresh=5, max_quality=qp(100))),
    "444_scd2": (64, 64, SUBSAMP_444, 8, 5, dict(
        quality=qp(75), gop=8, rc_mode=RATE_CONTROL_CRF, stable_refresh=7,
        scene_change_delta=2)),
    "odd_106x90": (106, 90, SUBSAMP_420, 5, -1, dict(
        quality=qp(60), gop=4, rc_mode=RATE_CONTROL_CRF, stable_refresh=3)),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_encoder_matches_jax(name):
    w, h, subsamp, n, cut_at, kw = SETTINGS[name]
    frames = corpus.make_clip_frames(w, h, subsamp, n, seed=w * h)
    if cut_at >= 0:
        frames = _brighten(frames, cut_at)
    meta = Metadata(w, h, subsamp)
    want = _jax(meta, kw, frames)
    got = _port(meta, kw, frames)
    assert len(got) == len(want)
    assert got == want


def test_force_metadata_mid_gop():
    w, h, n = 96, 80, 8
    frames = corpus.make_clip_frames(w, h, SUBSAMP_420, n, seed=21)
    kw = dict(quality=qp(70), gop=12, rc_mode=RATE_CONTROL_CRF,
              stable_refresh=11)
    streams = []
    for enc in (jenc.Encoder(Metadata(w, h, SUBSAMP_420),
                             jenc.EncoderConfig(**kw)),
                dt.Encoder(dt.Metadata(w, h, SUBSAMP_420),
                           dt.EncoderConfig(**kw), device="cpu")):
        enc.start()
        out, n_meta = bytearray(), 0
        for i, f in enumerate(frames):
            if i == 4:
                enc.force_metadata()   # frame 4 restarts the GOP
            pkts = enc.encode(f)
            n_meta += len(pkts) == 2
            for p in pkts:
                out += p
        out += enc.end_of_stream()
        assert n_meta == 2
        streams.append(bytes(out))
    assert streams[1] == streams[0]


def _resume(first, second, frames, cut):
    """Encode frames[:cut] with `first`, pickle its state, load it into
    `second` and encode the rest: the whole stream."""
    first.start()
    out = bytearray()
    for f in frames[:cut]:
        for pkt in first.encode(f):
            out += pkt
    blob = pickle.dumps(first.state_dict())   # ship it across hosts
    second.start()
    second.load_state_dict(pickle.loads(blob))
    for f in frames[cut:]:
        for pkt in second.encode(f):
            out += pkt
    out += second.end_of_stream()
    return bytes(out)


CKPT_KW = dict(quality=qp(75), gop=5, bitrate=400 * 1024, stable_refresh=4)


@pytest.mark.parametrize("rc", [RATE_CONTROL_CRF, RATE_CONTROL_ABR])
def test_resume_jax_state_in_port(rc):
    """A JAX Encoder's state_dict after 7 of 12 frames (int16 stability,
    numpy images) resumes in the port: the JAX uninterrupted stream."""
    w, h, n, cut = 96, 80, 12, 7
    frames = _brighten(corpus.make_clip_frames(w, h, SUBSAMP_420, n,
                                               seed=31), 9)
    meta = Metadata(w, h, SUBSAMP_420)
    kw = dict(CKPT_KW, rc_mode=rc)
    want = _jax(meta, kw, frames)
    first = jenc.Encoder(meta, jenc.EncoderConfig(**kw))
    got = _resume(first, dt.Encoder(dt.Metadata(w, h, SUBSAMP_420),
                                    dt.EncoderConfig(**kw), device="cpu"),
                  frames, cut)
    assert got == want


def test_resume_port_state():
    """The port's state_dict has the JAX keys and dtypes, resumes in the
    port and in the JAX Encoder; both give the uninterrupted stream."""
    w, h, n, cut = 96, 80, 12, 7
    frames = corpus.make_clip_frames(w, h, SUBSAMP_420, n, seed=31)
    meta, tmeta = Metadata(w, h, SUBSAMP_420), dt.Metadata(w, h, SUBSAMP_420)
    kw = dict(CKPT_KW, rc_mode=RATE_CONTROL_ABR)
    want = _jax(meta, kw, frames)

    def port():
        return dt.Encoder(tmeta, dt.EncoderConfig(**kw), device="cpu")

    probe = port()
    probe.start()
    for f in frames[:cut]:
        probe.encode(f)
    s = probe.state_dict()
    ref = jenc.Encoder(meta, jenc.EncoderConfig(**kw))
    ref.start()
    for f in frames[:cut]:
        ref.encode(f)
    js = ref.state_dict()
    assert sorted(s) == sorted(js)
    for k in ("stability", "stable_blocks", "ref_recon"):
        assert s[k].dtype == js[k].dtype and s[k].shape == js[k].shape
        np.testing.assert_array_equal(s[k], js[k])
    assert [x.dtype for x in s["ref_pyr"]] == [x.dtype for x in js["ref_pyr"]]
    assert {k: s[k] for k in tenc.Encoder._STATE_SCALARS} == \
        {k: js[k] for k in tenc.Encoder._STATE_SCALARS}

    assert _resume(port(), port(), frames, cut) == want
    assert _resume(port(), jenc.Encoder(meta, jenc.EncoderConfig(**kw)),
                   frames, cut) == want


def test_gop0_encode_stream_gops():
    """Intra-only CRF through encode_stream_gops: the JAX package's
    bytes, and the port's own Encoder's."""
    w, h, n = 106, 90, 5
    frames = corpus.make_clip_frames(w, h, SUBSAMP_444, n, seed=4)
    kw = dict(quality=qp(80), gop=0, rc_mode=RATE_CONTROL_CRF,
              stable_refresh=1)
    want = encode_stream_gops(frames, Metadata(w, h, SUBSAMP_444),
                              jenc.EncoderConfig(**kw))
    tmeta = dt.Metadata(w, h, SUBSAMP_444)
    got = dt.encode_stream_gops(frames, tmeta, dt.EncoderConfig(**kw),
                                device="cpu")
    assert got == want
    assert _port(Metadata(w, h, SUBSAMP_444), kw, frames) == want


@pytest.mark.parametrize("kw", [
    dict(gop=0, rc_mode=RATE_CONTROL_ABR),    # ABR needs the Encoder
    dict(gop=5000, rc_mode=RATE_CONTROL_CRF),  # too long a GOP
])
def test_gop_errors_name_the_encoder(kw):
    frames = corpus.make_clip_frames(48, 32, SUBSAMP_420, 1, seed=1)
    meta = Metadata(48, 32, SUBSAMP_420)
    with pytest.raises(ValueError, match="Encoder") as jerr:
        encode_stream_gops(frames, meta, jenc.EncoderConfig(**kw))
    with pytest.raises(ValueError, match="Encoder") as terr:
        dt.encode_stream_gops(frames, dt.Metadata(48, 32, SUBSAMP_420),
                              dt.EncoderConfig(**kw), device="cpu")
    assert str(terr.value) == str(jerr.value)


def _rc_state(quality):
    return SimpleNamespace(rc_quant=quality, bpf_total=0, bpf_reset=0,
                           bpf_avg=0, total_P_frame_q=0,
                           avg_P_frame_q=quality * 4 // 5,
                           last_P_frame_over=0, back_into_range=0)


def test_host_abr_law_matches_jax():
    """quality2quant_abr and rc_stats_update_abr on Python ints: the
    JAX package's law step for step, including picture sizes far past
    the int32 range of the device law's intermediates (ops/rc.py)."""
    rng = np.random.default_rng(9)
    meta = Metadata(352, 288, SUBSAMP_420)
    for bitrate, nudge, max_step in ((300 * 1024, True, 10),
                                     (40 * 1024, False, 2047),
                                     (5000 * 1024, True, 0)):
        kw = dict(quality=qp(80), bitrate=bitrate, rc_mode=RATE_CONTROL_ABR,
                  rc_high_motion_nudge=nudge, max_q_step=max_step)
        jcfg, tcfg = jenc.EncoderConfig(**kw), dt.EncoderConfig(**kw)
        js, ts = _rc_state(kw["quality"]), _rc_state(kw["quality"])
        for _ in range(300):
            is_p = bool(rng.random() < 0.8)
            forced = bool(rng.random() < 0.1) and not is_p
            plen = int(rng.choice([rng.integers(1, 4000),
                                   rng.integers(4000, 200000),
                                   rng.integers(2**23, 2**26)]))
            jq = jenc.quality2quant_abr(js, jcfg, meta, is_p, forced)
            tq = tenc.quality2quant_abr(ts, tcfg, meta, is_p, forced)
            assert tq == jq
            jenc.rc_stats_update_abr(js, jcfg, meta, is_p, jq, plen)
            tenc.rc_stats_update_abr(ts, tcfg, meta, is_p, tq, plen)
            assert vars(ts) == vars(js)
        assert tcfg.max_q_step == jcfg.max_q_step
