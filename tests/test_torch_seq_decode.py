"""PyTorch port vs JAX: the sequential Decoder, its overlay and the
GOP decoder's fallback to it.

On streams the JAX package writes (gop 6, ABR with a scene cut, gop 0,
4:2:2), the port's `Decoder(device="cpu")` must return, packet by
packet, the JAX `Decoder`'s codes and planes: with the `draw_info`
overlays 1, 2, 4 and 7, on a picture cut short (DEC_ERROR, and decoding
goes on), on a P picture with no reference and on pictures before any
metadata. A stream whose block size changes mid-stream (a 96x80 stream,
16x16 blocks, then a 400x300 one, 24x16) must decode through the port's
`iter_decode_gops` as through the JAX package's. Exact equality."""

import numpy as np
import pytest
import torch

from dsv1_tpu.constants import (RATE_CONTROL_ABR, RATE_CONTROL_CRF,
                                SUBSAMP_420, SUBSAMP_422, quality_percent)
from dsv1_tpu.models import decoder as jdec
from dsv1_tpu.models.bitstream import iter_packets
from dsv1_tpu.models.encoder import Encoder, EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.parallel import iter_decode_gops
import dsv1_tpu_torch as dt

from . import corpus

torch.set_num_threads(1)

qp = quality_percent


def _stream(w, h, subsamp, n, kw, seed=5, cut_at=-1):
    """A stream of the JAX package's sequential Encoder (its CRF bytes
    are those of encode_stream_gops; it compiles faster)."""
    frames = corpus.make_clip_frames(w, h, subsamp, n, seed=seed)
    if cut_at >= 0:
        frames = [(np.clip(y.astype(np.int32) + 90, 0, 255)
                   .astype(np.uint8) if i >= cut_at else y, u, v)
                  for i, (y, u, v) in enumerate(frames)]
    enc = Encoder(Metadata(w, h, subsamp), EncoderConfig(**kw))
    enc.start()
    return enc.encode_stream(frames)


STREAMS = {
    "gop6": (96, 80, SUBSAMP_420, 8, dict(
        quality=qp(85), gop=6, rc_mode=RATE_CONTROL_CRF, stable_refresh=5)),
    "abr": (96, 80, SUBSAMP_420, 8, dict(
        quality=qp(80) * 3 // 2, gop=4, rc_mode=RATE_CONTROL_ABR,
        bitrate=300 * 1024, stable_refresh=3, max_quality=qp(100))),
    "gop0": (96, 80, SUBSAMP_420, 3, dict(
        quality=qp(70), gop=0, rc_mode=RATE_CONTROL_CRF, stable_refresh=1)),
    "422": (64, 48, SUBSAMP_422, 6, dict(
        quality=qp(85), gop=4, rc_mode=RATE_CONTROL_CRF, stable_refresh=3)),
}


def _packets(stream):
    return [pkt for _t, pkt in iter_packets(stream)]


def _run(dec, packets):
    """Every packet through decode_packet: [(code, planes, fno)]."""
    return [dec.decode_packet(p) for p in packets]


def _assert_same(got, want):
    assert [(c, f) for c, _p, f in got] == [(c, f) for c, _p, f in want]
    for (_c, gp, _f), (_c2, wp, _f2) in zip(got, want):
        assert (gp is None) == (wp is None)
        for a, b in zip(gp or (), wp or ()):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", list(STREAMS))
def test_decoder_matches_jax(name):
    w, h, subsamp, n, kw = STREAMS[name]
    packets = _packets(_stream(w, h, subsamp, n, kw,
                               cut_at=5 if name == "abr" else -1))
    want = _run(jdec.Decoder(), packets)
    got = _run(dt.Decoder(device="cpu"), packets)
    assert sum(c == dt.DEC_OK for c, _p, _f in want) == n
    _assert_same(got, want)
    tdec = dt.Decoder(device="cpu")
    frames = list(tdec.decode_stream(b"".join(packets)))
    assert [f for f, _ in frames] == list(range(n))
    assert vars(tdec.get_metadata()) == vars(Metadata(w, h, subsamp))


@pytest.mark.parametrize("flags", [1, 2, 4, 7])
def test_drawinfo_matches_jax(flags):
    """The overlay of stable blocks, motion vectors and intra sub-blocks
    on P pictures (a gop 4 CRF stream with a scene cut)."""
    packets = _packets(_stream(96, 80, SUBSAMP_420, 8, dict(
        quality=qp(85), gop=4, rc_mode=RATE_CONTROL_CRF, stable_refresh=3),
        cut_at=6))
    want = _run(jdec.Decoder(draw_info=flags), packets)
    got = _run(dt.Decoder(draw_info=flags, device="cpu"), packets)
    _assert_same(got, want)
    plain = _run(dt.Decoder(device="cpu"), packets)
    assert any((g[1] is not None) and (g[1][0] != p[1][0]).any()
               for g, p in zip(got, plain))


def test_damaged_streams_match_jax():
    """A picture cut in half is DEC_ERROR and decoding goes on; a P
    picture with no reference is DEC_ERROR; pictures before any
    metadata are DEC_OK with no planes; a packet with a bad fourcc or
    an unknown type is DEC_ERROR."""
    w, h, subsamp, n, kw = STREAMS["gop6"]
    packets = _packets(_stream(w, h, subsamp, n, kw))
    meta, pics, eos = packets[0], packets[1:-1], packets[-1]
    bad_type = bytearray(pics[0])
    bad_type[5] = 0x08
    seq = ([pics[1], pics[0], meta, pics[2]]      # before meta; P, no ref
           + [pics[0], pics[1][:len(pics[1]) // 2]] + pics[2:]
           + [b"XXXX" + pics[0][4:], bytes(bad_type), eos])
    want = _run(jdec.Decoder(), seq)
    got = _run(dt.Decoder(device="cpu"), seq)
    _assert_same(got, want)
    codes = [c for c, _p, _f in got]
    assert codes[:4] == [dt.DEC_OK, dt.DEC_OK, dt.DEC_GOT_META,
                         dt.DEC_ERROR]
    assert codes[5] == dt.DEC_ERROR and codes[6] == dt.DEC_OK
    assert codes[-3:] == [dt.DEC_ERROR, dt.DEC_ERROR, dt.DEC_EOS]


def test_block_size_change_falls_back_to_decoder():
    """A 96x80 stream (16x16 blocks) without its EOS, then a 400x300
    one (24x16): the GOP decoder hands the stream to the sequential
    Decoder, as the JAX package's does."""
    a = _packets(_stream(96, 80, SUBSAMP_420, 3, STREAMS["gop6"][4]))
    b = _stream(400, 300, SUBSAMP_420, 2, dict(
        quality=qp(85), gop=2, rc_mode=RATE_CONTROL_CRF, stable_refresh=1))
    stream = b"".join(a[:-1]) + b
    jbox, tbox = {}, {}
    want = list(iter_decode_gops(stream, _meta_box=jbox))
    got = list(dt.iter_decode_gops(stream, "cpu", meta_box=tbox))
    assert [f for f, _ in got] == [f for f, _ in want] == [0, 1, 2, 0, 1]
    assert [p[0].shape for _f, p in got] == [(80, 96)] * 3 + [(300, 400)] * 2
    for (_f, gp), (_f2, wp) in zip(got, want):
        for x, y in zip(gp, wp):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert vars(tbox["meta"]) == vars(jbox["meta"])
