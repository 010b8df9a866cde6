"""Interleaved exp-Golomb (UEG) codes and vectorized bit packing.

The DSV1 bitstream uses MSB-first bit packing with three interleaved
exp-Golomb code families (reference bs.c:128-219) and a zero-bit run-length
format (ZBRLE, bs.c:221-267).

This module computes code words *vectorized* (numpy, host side): a UEG code
for value v is derived in closed form as an integer + bit length, so an
entire symbol stream becomes two arrays. Packing is a prefix-sum + scatter
over a bit array — O(total_bits) vectorized work instead of the reference's
per-bit loop. A native C++ path (dsv1_tpu_torch.bits) accelerates the
serial decode side. The port's copy of the parts of dsv1_tpu/ops/golomb.py it
uses: the packet headers and metadata (models/bitstream.py); pictures
are packed and parsed natively.

UEG closed form: for v, let v' = v + 1, k = floor(log2(v')), m = v' - 2^k.
The emitted bits are (0, b_{k-1}, 0, b_{k-2}, ..., 0, b_0, 1) where b_i are
the low k bits of v'. As an MSB-first integer: code = 1 + 2*spread(m), with
spread() interleaving zeros between bits; length = 2k + 1.
"""

import numpy as np


def _spread_bits_u64(x):
    """Interleave zero bits: bit j of x moves to bit 2j (x < 2^32)."""
    x = x.astype(np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _floor_log2_u32(x):
    """floor(log2(x)) for x >= 1 (vectorized)."""
    return (np.frexp(x.astype(np.float64))[1] - 1).astype(np.int64)


def ueg_codes(v):
    """Vectorized UEG codes. v: non-negative ints. Returns (codes u64, lens i64)."""
    v = np.asarray(v, dtype=np.uint32)
    vp = (v + np.uint32(1)).astype(np.uint32)
    k = _floor_log2_u32(vp)
    m = vp - (np.uint64(1) << k.astype(np.uint64)).astype(np.uint32)
    codes = np.uint64(1) + (_spread_bits_u64(m) << np.uint64(1))
    lens = 2 * k + 1
    return codes, lens


class BitWriter:
    """MSB-first bit writer backed by a growable byte buffer.

    Mirrors DSV_BS semantics (bs.c:21-126) including byte alignment and
    aligned byte concatenation; put_symbols() appends whole entropy-coded
    symbol streams through the native packer (native/dsvbits.cpp) —
    memcpy-speed instead of one numpy element per bit.
    """

    def __init__(self, capacity_bits: int = 1 << 16):
        self._buf = np.zeros(max(capacity_bits >> 3, 64), dtype=np.uint8)
        self.pos = 0  # bit position

    def _ensure(self, nbits: int):
        need = (self.pos + nbits + 7) >> 3
        if need > self._buf.size:
            nb = np.zeros(max(need, self._buf.size * 2), dtype=np.uint8)
            n = min((self.pos + 7) >> 3, self._buf.size)
            nb[:n] = self._buf[:n]
            self._buf = nb

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def _set_bit(self, bitpos: int, b: int):
        mask = 1 << (7 - (bitpos & 7))
        if b & 1:
            self._buf[bitpos >> 3] |= mask
        else:
            self._buf[bitpos >> 3] &= 0xFF ^ mask

    def put_bits(self, n: int, value: int):
        self._ensure(n)
        for i in range(n - 1, -1, -1):
            self._set_bit(self.pos, (value >> i) & 1)
            self.pos += 1

    def put_ueg(self, v: int):
        codes, lens = ueg_codes(np.asarray([v]))
        self.put_symbols(codes, lens)

    def put_symbols(self, codes, lens):
        """Append a stream of (code, bitlength) symbols (native packer)."""
        from .. import bits as native_bits
        codes = np.asarray(codes, dtype=np.uint64)
        lens = np.asarray(lens, dtype=np.int64)
        total = int(lens.sum())
        if total == 0:
            return
        self._ensure(total)
        self.pos = native_bits.pack_symbols(codes, lens, self._buf, self.pos)

    def getvalue(self) -> bytes:
        self.align()
        return self._buf[: self.pos >> 3].tobytes()


class BitReader:
    """MSB-first bit reader over a byte buffer (mirrors bs.c read side)."""

    def __init__(self, data: bytes):
        self._bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0

    def get_bit(self) -> int:
        b = int(self._bits[self.pos]) if self.pos < self._bits.size else 0
        self.pos += 1
        return b

    def get_ueg(self) -> int:
        v = 1
        while not self.get_bit():
            v = (v << 1) | self.get_bit()
            if v > (1 << 30):  # corrupt/truncated-stream backstop: past
                break          # the end get_bit() yields zeros forever
                               # (mirrors native BitReader, dsvbits.cpp)
        return v - 1
