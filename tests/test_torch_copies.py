"""The port's own copies of the JAX package's jax-free modules agree with
their originals: constants name by name, the native packer byte for
byte (pack_picture, encode_motion) and the native parser field by field
(parse_picture), the metadata/EOS packets, the YUV reader and the
golden clip generators."""

import numpy as np
import pytest

from dsv1_tpu import bits as jbits, constants as jconst
from dsv1_tpu.constants import FOURCC, MAX_QP_BITS, VERSION_MINOR, make_pt
from dsv1_tpu.models import bitstream as jbs
from dsv1_tpu.models.metadata import Metadata as JMeta
from dsv1_tpu.ops.hzcc import runs_from_qvals
from dsv1_tpu.utils import bitrate as jbitrate, chroma as jchroma, \
    yuv as jyuv
from dsv1_tpu_torch import bits as tbits, constants as tconst
from dsv1_tpu_torch.models import bitstream as tbs
from dsv1_tpu_torch.models.metadata import Metadata as TMeta
from dsv1_tpu_torch.utils import bitrate as tbitrate, chroma as tchroma, \
    corpus as tcorpus, yuv as tyuv

from . import corpus


def test_constants_equal_name_by_name():
    names = [n for n in dir(jconst) if not n.startswith("_")]
    assert names == [n for n in dir(tconst) if not n.startswith("_")]
    for n in names:
        a, b = getattr(jconst, n), getattr(tconst, n)
        if callable(a):
            for x in (0, 1, 5, 6, 7, 13, 300, 2047):
                if n in ("round_shift", "round_pow2", "div_round"):
                    assert a(x + 1, 3) == b(x + 1, 3), n
                elif n == "make_pt":
                    assert a(x & 1, x & 2) == b(x & 1, x & 2), n
                else:
                    assert a(x) == b(x), n
        else:
            assert a == b, n


def _motion(rng, nblk):
    mode = (rng.random(nblk) < 0.3).astype(np.uint8)
    mvx = np.where(mode == 0, rng.integers(-900, 900, nblk), 0) \
        .astype(np.int16)
    mvy = np.where(mode == 0, rng.integers(-900, 900, nblk), 0) \
        .astype(np.int16)
    sub = np.where(mode == 1, rng.integers(0, 16, nblk), 0).astype(np.uint8)
    return mode, mvx, mvy, sub


@pytest.mark.parametrize("seed,has_ref,density", [
    (0, False, 0.05), (1, True, 0.3), (2, True, 0.0), (3, False, 1.0),
])
def test_native_packer_and_parser_equal(seed, has_ref, density):
    rng = np.random.default_rng(seed)
    w, h, bw, bh = 100, 84, 16, 16
    nbh, nbv = -(-w // bw), -(-h // bh)
    nblk = nbh * nbv
    stable = (rng.random(nblk) < 0.5).astype(np.uint8)
    mode, mvx, mvy, sub = _motion(rng, nblk)
    assert jbits.encode_motion(mode, mvx, mvy, sub, nbh, nbv) \
        == tbits.encode_motion(mode, mvx, mvy, sub, nbh, nbv)
    sizes = (w * h, 50 * 42, 50 * 42)
    planes = []
    for n in sizes:
        qv = np.where(rng.random(n) < density, rng.integers(-900, 900, n),
                      0).astype(np.int32)
        planes.append((*runs_from_qvals(qv), int(rng.integers(-300, 300))))
    args = (FOURCC, VERSION_MINOR, make_pt(True, has_ref), 7, bw, bh, nbh,
            nbv, stable, has_ref, mode if has_ref else None,
            mvx if has_ref else None, mvy if has_ref else None,
            sub if has_ref else None, int(rng.integers(5, 2047)),
            MAX_QP_BITS, planes)
    pkt = jbits.pack_picture(*args)
    assert tbits.pack_picture(*args) == pkt
    pa = jbits.parse_picture(bytes(pkt), w, h, MAX_QP_BITS, 16, 64, sizes)
    pb = tbits.parse_picture(bytes(pkt), w, h, MAX_QP_BITS, 16, 64, sizes)
    assert pa[0] == pb[0]
    for a, b in zip(pa[1:6], pb[1:6]):
        np.testing.assert_array_equal(a, b)
    for (dca, ra, va, la), (dcb, rb, vb, lb) in zip(pa[6], pb[6]):
        assert (dca, la) == (dcb, lb)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(va, vb)


def test_packets_and_host_helpers_equal(tmp_path):
    meta = (1920, 1080, 0x5, 24000, 1001, 16, 9)
    pkt = jbs.encode_metadata_packet(JMeta(*meta))
    assert tbs.encode_metadata_packet(TMeta(*meta)) == pkt
    assert tbs.parse_metadata(bytes(pkt)) == TMeta(*meta)
    assert tbs.encode_eos_packet(12345) == jbs.encode_eos_packet(12345)
    for s in (0x0, 0x4, 0x5, 0x8):
        for g in (0, 12):
            m = (352, 288, s)
            assert tbitrate.estimate_bitrate(85, g, TMeta(*m)) \
                == jbitrate.estimate_bitrate(85, g, JMeta(*m))
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (9, 13)).astype(np.uint8)
    np.testing.assert_array_equal(tchroma.conv444to422(a),
                                  jchroma.conv444to422(a))
    np.testing.assert_array_equal(tchroma.conv422to420(a),
                                  jchroma.conv422to420(a))
    clip = corpus.make_clip(48, 32, 0x5, 3, seed=8)
    assert tcorpus.make_clip(48, 32, 0x5, 3, seed=8) == clip
    assert tcorpus.make_rich_clip(64, 48, 0x5, 3, seed=8) \
        == corpus.make_rich_clip(64, 48, 0x5, 3, seed=8)
    (tmp_path / "c.yuv").write_bytes(clip)
    with open(tmp_path / "c.yuv", "rb") as f:
        for fno in (0, 2, 3):
            ra, rb = jyuv.read_frame(f, fno, 48, 32, 0x5), \
                tyuv.read_frame(f, fno, 48, 32, 0x5)
            assert (ra is None) == (rb is None)
            for x, y in zip(ra or (), rb or ()):
                np.testing.assert_array_equal(x, y)
