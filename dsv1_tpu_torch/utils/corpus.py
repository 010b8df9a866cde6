"""Synthetic YUV clips (the port's copy of the generators in
tests/corpus.py): a moving textured square over a noisy gradient, and a
panned textured scene with crossing occluders. Both are raw planar
bytes made from a numpy seed, so the same seed gives the same clip on
every machine; `dsv1_tpu_torch/data/golden.json` records their SHA-256.
"""

import numpy as np

from ..constants import format_h_shift, format_v_shift, round_shift


def make_clip(w, h, subsamp, nframes, seed=0, motion=True, cut_at=-1):
    """Moving textured square over noisy gradient; returns planar bytes.
    cut_at >= 0 halves the luma from that frame on: a hard scene cut (the
    average luma drops by about 64), which forces an intra frame."""
    rng = np.random.default_rng(seed)
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(w, hs), round_shift(h, vs)
    frames = []
    base = (np.linspace(0, 200, w)[None, :]
            + np.linspace(0, 55, h)[:, None]).astype(np.int32)
    tex = rng.integers(-18, 18, (h, w))
    for i in range(nframes):
        y = base + tex
        if motion:
            sx, sy = (13 + 5 * i) % max(w - 24, 1), (11 + 3 * i) % max(h - 24, 1)
            y = y.copy()
            y[sy:sy + 20, sx:sx + 20] += 60
            y = np.roll(y, i, axis=1)
        y = np.clip(y + rng.integers(-4, 4, (h, w)), 0, 255).astype(np.uint8)
        if 0 <= cut_at <= i:
            y >>= 1
        u = np.clip(110 + rng.integers(-9, 9, (ch, cw)) + (i * 2), 0,
                    255).astype(np.uint8)
        v = np.clip(135 + rng.integers(-9, 9, (ch, cw)), 0, 255).astype(np.uint8)
        frames += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(frames)


def make_rich_clip(w, h, subsamp, nframes, seed=0):
    """Realistic-motion clip: global pan over a textured background, two
    textured occluders on crossing trajectories (occluding the background
    and each other), a static high-texture strip (exercises stability
    tracking), colored chroma on the objects, and mild sensor noise.
    Returns planar bytes."""
    rng = np.random.default_rng(seed)
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(w, hs), round_shift(h, vs)

    # background: smooth illumination + band-limited texture, panned
    gx = np.linspace(0, 170, w)[None, :] + np.linspace(0, 60, h)[:, None]
    texf = rng.integers(-30, 30, (h, w)).astype(np.float64)
    # cheap low-pass (3x3 box twice) => mid-frequency texture
    for _ in range(2):
        texf = (np.roll(texf, 1, 1) + texf + np.roll(texf, -1, 1)) / 3
        texf = (np.roll(texf, 1, 0) + texf + np.roll(texf, -1, 0)) / 3
    bg = (gx + 3.5 * texf).astype(np.int32)

    # two occluders with their own textures and chroma
    ow, oh = max(w // 6, 16), max(h // 5, 16)
    obj = [rng.integers(-25, 25, (oh, ow)) + lvl for lvl in (70, -50)]
    strip = rng.integers(-35, 35, (h // 8, w))  # static textured strip

    frames = []
    for i in range(nframes):
        # global pan: 2 px/frame horizontal, 1 px every 2 frames vertical
        y = np.roll(np.roll(bg, 2 * i, axis=1), i // 2, axis=0).copy()
        uc = np.full((h, w), 112, np.int32)
        vc = np.full((h, w), 136, np.int32)
        # occluders cross: one left-to-right, one diagonal
        pos = [((7 * i) % max(w - ow, 1), (h // 3)),
               ((w - ow - (5 * i) % max(w - ow, 1)),
                (3 * i) % max(h - oh, 1))]
        for k, (ox, oy) in enumerate(pos):
            y[oy:oy + oh, ox:ox + ow] = 128 + obj[k]
            uc[oy:oy + oh, ox:ox + ow] = 90 if k == 0 else 150
            vc[oy:oy + oh, ox:ox + ow] = 160 if k == 0 else 105
        y[-strip.shape[0]:, :] = 120 + strip  # static strip (no motion)
        y = np.clip(y + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(uc[::(1 << vs), ::(1 << hs)][:ch, :cw]
                    + rng.integers(-2, 3, (ch, cw)), 0, 255).astype(np.uint8)
        v = np.clip(vc[::(1 << vs), ::(1 << hs)][:ch, :cw]
                    + rng.integers(-2, 3, (ch, cw)), 0, 255).astype(np.uint8)
        frames += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(frames)


def split_frames(yuv: bytes, w: int, h: int, subsamp: int, n: int):
    """Raw planar clip bytes -> [(y, u, v), ...] uint8 arrays."""
    cw = round_shift(w, format_h_shift(subsamp))
    ch = round_shift(h, format_v_shift(subsamp))
    ysz, csz = w * h, cw * ch
    fsz = ysz + 2 * csz
    frames = []
    for i in range(n):
        f = np.frombuffer(yuv[i * fsz:(i + 1) * fsz], np.uint8)
        frames.append((f[:ysz].reshape(h, w),
                       f[ysz:ysz + csz].reshape(ch, cw),
                       f[ysz + csz:].reshape(ch, cw)))
    return frames
