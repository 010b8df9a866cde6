"""ctypes bindings to the reference's native bit-serial runtime
(native/dsvbits.cpp beside it, a copy of the JAX package's source).

Builds the shared library on first use (g++ -O3 -shared) into `build/`
of the checkout, named `libdsvref-<source hash>.so`, so the reference
never loads the JAX package's or the program's library. The serial entropy work runs
native; all per-coefficient math stays on the device.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "dsvbits.cpp"
_BUILD = Path(__file__).resolve().parents[4] / "build" / "bench_ref"

_lib = None


def _so_path() -> Path:
    """The library for this source, compiled if it is not there yet."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libdsvref-{tag}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        # build to a unique temp path, then rename: concurrent first runs
        # must never dlopen a partially written library
        tmp = _BUILD / f".libdsvref-{tag}.{os.getpid()}.so"
        subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
                        str(_SRC), "-o", str(tmp)], check=True)
        os.replace(tmp, so)
    return so


def lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(_so_path()))
        for name in ("dsv1n_pack_picture", "dsv1n_parse_picture",
                     "dsv1n_runs_from_dense8", "dsv1n_pack_chunk"):
            getattr(_lib, name).restype = ctypes.c_int32
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


def runs_from_dense8(q8: np.ndarray, epos: np.ndarray, evals: np.ndarray):
    """(runs u32, vals i32) symbol stream of a dense int8 plane with its
    sorted exception list (ops/hzcc.py compact_dense_i): the values of
    hzcc.runs_from_qvals on the plane they stand for."""
    q8 = np.ascontiguousarray(q8, np.int8)
    epos = np.ascontiguousarray(epos, np.int32)
    evals = np.ascontiguousarray(evals, np.int32)
    cap = q8.size
    runs = np.empty(max(cap, 1), np.uint32)
    vals = np.empty(max(cap, 1), np.int32)
    n = lib().dsv1n_runs_from_dense8(
        q8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int32(q8.size), _i32p(epos), _i32p(evals),
        ctypes.c_int32(epos.size), _u32p(runs), _i32p(vals),
        ctypes.c_int32(cap))
    assert n >= 0
    return runs[:n], vals[:n]


def pack_chunk(fourcc: bytes, version: int, blk_w: int, blk_h: int,
               nbh: int, nbv: int, quant, qp_bits: int, meta_pkt: bytes,
               C: int, G: int, g0: int, ngops: int, nframes: int,
               fnum_base: int, pt_ref: int, iq8, ipos, ivals, idc, istable,
               pruns, pvals, pcnt, pdc, phasref, pmode, pmvx, pmvy, psub,
               pstable, prev_link: int):
    """Assemble C GOPs of G frames into one packet byte stream natively
    (dsv1n_pack_chunk): per GOP a metadata packet, then its pictures, and
    the link chain across them.

    iq8/ipos/ivals: per plane, (C, ...) arrays of the I frames' dense
    int8 planes and sorted exception lists (hzcc.compact_dense_i);
    pruns/pvals/pcnt: per plane, (C, G-1, K) sparse (run, value) arrays
    (u16, i16) and (C, G-1) counts (hzcc.compact_sparse_p). quant: a
    scalar, a (C, 2) array of per-GOP (I, P) quants or a (C, G) array of
    per-frame quants. Frames from `nframes` on and GOPs from `ngops` on
    are left out. Returns (bytes, the new prev_link)."""
    fcc = np.frombuffer(fourcc, np.uint8)
    meta = np.frombuffer(bytes(meta_pkt), np.uint8)
    quants = (np.full((C, G), quant, np.int32) if np.isscalar(quant)
              else np.ascontiguousarray(quant, np.int32))
    if quants.shape == (C, 2) and G != 2:
        q2, quants = quants, np.empty((C, G), np.int32)
        quants[:, :1] = q2[:, :1]
        quants[:, 1:] = q2[:, 1:2]
    assert quants.shape == (C, G)

    def ptrs(arrs, dt):
        arrs = [np.ascontiguousarray(a, dt) for a in arrs]
        return arrs, (ctypes.c_void_p * 3)(*[a.ctypes.data for a in arrs])

    iq8_a, iq8_p = ptrs(iq8, np.int8)
    ipos_a, ipos_p = ptrs(ipos, np.int32)
    ivals_a, ivals_p = ptrs(ivals, np.int32)
    pruns_a, pruns_p = ptrs(pruns, np.uint16)
    pvals_a, pvals_p = ptrs(pvals, np.int16)
    pcnt_a, pcnt_p = ptrs(pcnt, np.int32)
    iN = np.asarray([a.shape[-1] for a in iq8_a], np.int32)
    iK = np.asarray([a.shape[-1] for a in ipos_a], np.int32)
    pK = np.asarray([a.shape[-1] for a in pruns_a], np.int32)
    idc = np.ascontiguousarray(idc, np.int32)
    istable = np.ascontiguousarray(istable, np.uint8)
    pdc = np.ascontiguousarray(pdc, np.int32)
    phasref = np.ascontiguousarray(phasref, np.uint8)
    pmode = np.ascontiguousarray(pmode, np.uint8)
    pmvx = np.ascontiguousarray(pmvx, np.int16)
    pmvy = np.ascontiguousarray(pmvy, np.int16)
    psub = np.ascontiguousarray(psub, np.uint8)
    pstable = np.ascontiguousarray(pstable, np.uint8)
    nblk = nbh * nbv
    # at most 10 bytes a symbol: the sparse counts plus the dense planes'
    # nonzeros and exceptions
    nsym = sum(int(np.count_nonzero(a)) for a in iq8_a) \
        + sum(int(a.shape[-1]) for a in ipos_a) * C \
        + sum(int(c.sum()) for c in pcnt_a)
    cap = (len(meta) + 64) * C + (C * G) * (192 + nblk * 10) + nsym * 10
    pl = ctypes.c_int64(prev_link)
    while True:
        out = np.zeros(cap, np.uint8)   # the C side ORs bits into it
        n = lib().dsv1n_pack_chunk(
            _u8p(fcc), ctypes.c_uint8(version), ctypes.c_int32(blk_w),
            ctypes.c_int32(blk_h), ctypes.c_int32(nbh), ctypes.c_int32(nbv),
            _i32p(quants), ctypes.c_int32(qp_bits), _u8p(meta),
            ctypes.c_int32(meta.size), ctypes.c_int32(C), ctypes.c_int32(G),
            ctypes.c_int64(g0), ctypes.c_int64(ngops),
            ctypes.c_int64(nframes), ctypes.c_int64(fnum_base),
            ctypes.c_int32(pt_ref), iq8_p, ipos_p, ivals_p, _i32p(iN),
            _i32p(iK), _i32p(idc), _u8p(istable), pruns_p, pvals_p, pcnt_p,
            _i32p(pK), _i32p(pdc), _u8p(phasref), _u8p(pmode), _i16p(pmvx),
            _i16p(pmvy), _u8p(psub), _u8p(pstable), ctypes.byref(pl),
            _u8p(out), ctypes.c_int64(cap))
        if n >= 0:
            return out[:n].tobytes(), int(pl.value)
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
