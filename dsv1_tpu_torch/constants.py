"""DSV1 bitstream constants (the port's copy of dsv1_tpu/constants.py).

Mirrors the normative constants of the DSV1 specification (reference:
dsv.h:27-82,155-158 and dsv_internal.h:30-37,88-92).
"""

# B.1 packet header (dsv.h:28-47)
FOURCC = b"DSV1"
VERSION_MINOR = 0

PT_META = 0x00
PT_PIC = 0x04
PT_EOS = 0x10


def make_pt(is_ref: int, has_ref: int) -> int:
    return PT_PIC | (int(bool(is_ref)) << 1) | int(bool(has_ref))


def pt_is_pic(t: int) -> bool:
    return bool(t & 0x4)


def pt_is_ref(t: int) -> bool:
    return (t & 0x6) == 0x6


def pt_has_ref(t: int) -> bool:
    return bool(t & 0x1)


PACKET_HDR_SIZE = 4 + 1 + 1 + 4 + 4
PACKET_TYPE_OFFSET = 5
PACKET_PREV_OFFSET = 6
PACKET_NEXT_OFFSET = 10

# B.2.3 picture packet (dsv.h:50-51)
MIN_BLOCK_SIZE = 16
MAX_BLOCK_SIZE = 64
FRAME_BORDER = MAX_BLOCK_SIZE

# chroma subsampling nibbles (dsv.h:66-82)
FMT_FULL_V = 0x0
FMT_DIV2_V = 0x1
FMT_DIV4_V = 0x2
FMT_FULL_H = 0x0
FMT_DIV2_H = 0x4
FMT_DIV4_H = 0x8

SUBSAMP_444 = FMT_FULL_H | FMT_FULL_V
SUBSAMP_422 = FMT_DIV2_H | FMT_FULL_V
SUBSAMP_420 = FMT_DIV2_H | FMT_DIV2_V
SUBSAMP_411 = FMT_DIV4_H | FMT_FULL_V


def format_h_shift(fmt: int) -> int:
    return (fmt >> 2) & 0x3


def format_v_shift(fmt: int) -> int:
    return fmt & 0x3


# B.2.3.2 intra sub-block masks (dsv.h:128-135)
MODE_INTER = 0
MODE_INTRA = 1
MASK_INTRA00 = 1
MASK_INTRA01 = 2
MASK_INTRA10 = 4
MASK_INTRA11 = 8
MASK_ALL_INTRA = MASK_INTRA00 | MASK_INTRA01 | MASK_INTRA10 | MASK_INTRA11

# B.2.3.3 quantization parameter (dsv.h:155-158)
MAX_QP_BITS = 11
MAX_QUALITY = (1 << MAX_QP_BITS) - 1


def quality_percent(pct: int) -> int:
    return MAX_QUALITY * pct // 100


def quant_of_quality(q):
    """quality -> 11-bit picture quant (the quality2quant tail,
    dsv_encoder.c:165). Elementwise on numpy arrays (q >= 0, so floor
    division matches C's truncating division)."""
    return MAX_QUALITY - (MAX_QUALITY - 5) * q // MAX_QUALITY


# motion data substreams (dsv_internal.h:30-35)
SUB_MODE = 0
SUB_MV_X = 1
SUB_MV_Y = 2
SUB_SBIM = 3
SUB_NSUB = 4

# HZCC (dsv_internal.h:88-92, hzcc.c:21-27,59-61)
MAXLVL = 3
QP_I = 3
QP_P = 1
EOP_SYMBOL = 0x55
CHROMA_LIMIT = 512
NSUBBAND = 4
MINQUANT = 16
BLOCK_P = 14
IS_STABLE = 1
IS_INTRA = 2

# D.1.1 luma half-pel filter coefficient (dsv_internal.h:106)
HP_COEF = 9

# encoder (dsv_encoder.h:26-35, hme.c:28-30)
GOP_INTRA = 0
GOP_INF = 2**31 - 1
RATE_CONTROL_CRF = 0
RATE_CONTROL_ABR = 1
MAX_PYRAMID_LEVELS = 5
BPF_RESET = 256
HP_SAD_SZ = 14


def round_shift(x: int, s: int) -> int:
    """DSV_ROUND_SHIFT for non-negative python ints (dsv.h:62)."""
    return (x + (1 << s) - 1) >> s


def round_pow2(x: int, p: int) -> int:
    """DSV_ROUND_POW2 (dsv.h:63)."""
    return (x + (1 << p) - 1) & (~0 << p) & 0xFFFFFFFF


def div_round(a: int, b: int) -> int:
    """DSV_DIV_ROUND (dsv.h:64)."""
    return (a + b - 1) // b
