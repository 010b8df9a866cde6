"""ctypes bindings to the port's native bit-serial runtime
(dsv1_tpu_torch/native/dsvbits.cpp, a copy of the JAX package's source).

Builds the shared library on first use (g++ -O3 -shared) into `build/`
of the checkout, named `libdsvbits_torch-<source hash>.so`, so the port
never loads the JAX package's library. The serial entropy work runs
native; all per-coefficient math stays on the device.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "dsvbits.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"

_lib = None


def _so_path() -> Path:
    """The library for this source, compiled if it is not there yet."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libdsvbits_torch-{tag}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        # build to a unique temp path, then rename: concurrent first runs
        # must never dlopen a partially written library
        tmp = _BUILD / f".libdsvbits_torch-{tag}.{os.getpid()}.so"
        subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
                        str(_SRC), "-o", str(tmp)], check=True)
        os.replace(tmp, so)
    return so


def lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(_so_path()))
        _lib.dsv1n_pack_picture.restype = ctypes.c_int32
        _lib.dsv1n_parse_picture.restype = ctypes.c_int32
    return _lib


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def encode_motion(modes, mvx, mvy, submask, nbh: int, nbv: int):
    """Encode motion data -> 4 byte buffers (mode, mvx, mvy, sbim)."""
    cap = max(64, nbh * nbv * 32)
    outs = [np.zeros(cap, np.uint8) for _ in range(4)]
    lens = [ctypes.c_uint32(0) for _ in range(4)]
    modes = np.ascontiguousarray(modes, np.uint8)
    mvx = np.ascontiguousarray(mvx, np.int16)
    mvy = np.ascontiguousarray(mvy, np.int16)
    submask = np.ascontiguousarray(submask, np.uint8)
    lib().dsv1n_encode_motion(
        _u8p(modes), _i16p(mvx), _i16p(mvy), _u8p(submask),
        ctypes.c_int32(nbh), ctypes.c_int32(nbv),
        _u8p(outs[0]), ctypes.byref(lens[0]),
        _u8p(outs[1]), ctypes.byref(lens[1]),
        _u8p(outs[2]), ctypes.byref(lens[2]),
        _u8p(outs[3]), ctypes.byref(lens[3]),
        ctypes.c_uint32(cap),
    )
    return [outs[i][: lens[i].value].tobytes() for i in range(4)]


def pack_picture(fourcc: bytes, version: int, pkt_type: int, fnum: int,
                 blk_w: int, blk_h: int, nbh: int, nbv: int,
                 stable: np.ndarray, has_ref: bool, modes, mvx, mvy, submask,
                 quant: int, qp_bits: int, planes) -> bytearray:
    """Assemble one complete picture packet natively.

    planes: [(runs u32[], vals i32[], dc int)] * 3. Motion arrays may be
    None when has_ref is False.
    """
    stable = np.ascontiguousarray(stable, np.uint8)
    if has_ref:
        modes = np.ascontiguousarray(modes, np.uint8)
        mvx = np.ascontiguousarray(mvx, np.int16)
        mvy = np.ascontiguousarray(mvy, np.int16)
        submask = np.ascontiguousarray(submask, np.uint8)
        mp, xp, yp, sp = _u8p(modes), _i16p(mvx), _i16p(mvy), _u8p(submask)
    else:
        mp = xp = yp = sp = None
    pargs = []
    cap = 1024 + nbh * nbv * 24
    for runs, vals, dc in planes:
        runs = np.ascontiguousarray(runs, np.uint32)
        vals = np.ascontiguousarray(vals, np.int32)
        cap += 10 * runs.size + 64
        # data_as pointers keep their source arrays alive (numpy sets _arr)
        pargs += [_u32p(runs), _i32p(vals), ctypes.c_int32(runs.size),
                  ctypes.c_int32(int(dc))]
    fcc = np.frombuffer(fourcc, np.uint8)
    while True:
        out = np.zeros(cap, np.uint8)
        n = lib().dsv1n_pack_picture(
            _u8p(fcc), ctypes.c_uint8(version), ctypes.c_uint8(pkt_type),
            ctypes.c_uint32(fnum), ctypes.c_int32(blk_w),
            ctypes.c_int32(blk_h), ctypes.c_int32(nbh), ctypes.c_int32(nbv),
            _u8p(stable), ctypes.c_int32(int(has_ref)), mp, xp, yp, sp,
            ctypes.c_int32(quant), ctypes.c_int32(qp_bits), *pargs,
            _u8p(out), ctypes.c_uint32(cap))
        if n >= 0:
            return bytearray(out[:n].tobytes())
        cap *= 2


def parse_picture(pkt: bytes, w: int, h: int, qp_bits: int,
                  min_blk: int, max_blk: int, max_syms):
    """Parse one picture packet natively (dsv1n_parse_picture).

    max_syms: per-plane symbol caps (the traversal sizes). Returns
    (hdr dict, stable u8[nblk], modes, mvx, mvy, submask,
     [(dc, runs u32[n], vals i32[n], plen)] * 3) or raises ValueError on
    malformed block dims.
    """
    buf = np.frombuffer(bytes(pkt), np.uint8)
    nblk_max = ((w + min_blk - 1) // min_blk) * ((h + min_blk - 1) // min_blk)
    hdr = np.zeros(8, np.int32)
    stable = np.zeros(nblk_max, np.uint8)
    modes = np.zeros(nblk_max, np.uint8)
    mvx = np.zeros(nblk_max, np.int16)
    mvy = np.zeros(nblk_max, np.int16)
    submask = np.zeros(nblk_max, np.uint8)
    ms = np.asarray(max_syms, np.int32)
    total = int(ms.sum())
    runs = np.empty(total, np.uint32)
    vals = np.empty(total, np.int32)
    pmeta = np.zeros(9, np.int32)
    rc = lib().dsv1n_parse_picture(
        _u8p(buf), ctypes.c_int64(buf.size),
        ctypes.c_int32(w), ctypes.c_int32(h), ctypes.c_int32(qp_bits),
        ctypes.c_int32(min_blk), ctypes.c_int32(max_blk),
        _i32p(hdr), _u8p(stable), _u8p(modes), _i16p(mvx), _i16p(mvy),
        _u8p(submask), _i32p(ms), _u32p(runs), _i32p(vals), _i32p(pmeta))
    if rc != 0:
        raise ValueError("bad block dims")
    nblk = int(hdr[4]) * int(hdr[5])
    planes = []
    off = 0
    for c in range(3):
        n = int(pmeta[c * 3 + 1])
        planes.append((int(pmeta[c * 3]), runs[off:off + n],
                       vals[off:off + n], int(pmeta[c * 3 + 2])))
        off += int(ms[c])
    hdr_d = dict(fno=int(np.uint32(hdr[0])), blk_w=int(hdr[1]),
                 blk_h=int(hdr[2]), quant=int(hdr[3]), nbh=int(hdr[4]),
                 nbv=int(hdr[5]), has_ref=bool(hdr[6]),
                 plen_err=bool(hdr[7]))
    return (hdr_d, stable[:nblk], modes[:nblk], mvx[:nblk], mvy[:nblk],
            submask[:nblk], planes)


def pack_symbols(codes: np.ndarray, lens: np.ndarray, out: np.ndarray,
                 bitpos: int) -> int:
    """Append symbols into pre-zeroed `out` at bit position; returns new pos."""
    codes = np.ascontiguousarray(codes, np.uint64)
    lens32 = np.ascontiguousarray(lens, np.int32)
    bp = ctypes.c_uint32(bitpos)
    lib().dsv1n_pack_symbols(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _i32p(lens32), ctypes.c_int32(codes.size),
        _u8p(out), ctypes.c_uint32(out.size), ctypes.byref(bp),
    )
    return int(bp.value)
