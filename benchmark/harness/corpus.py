"""The traffic's clips: a frozen copy of the port's `make_rich_clip`
(dsv1_tpu_torch/utils/corpus.py), made from a numpy seed, so the same
seed gives the same clip on every machine."""

import numpy as np


def plane_dims(w: int, h: int, subsamp: int):
    """(chroma width, chroma height) of a DSV1 format code (its bits 2-3
    the horizontal shift, bits 0-1 the vertical one)."""
    hs, vs = (subsamp >> 2) & 3, subsamp & 3
    return (w + (1 << hs) - 1) >> hs, (h + (1 << vs) - 1) >> vs


def make_rich_clip(w, h, subsamp, nframes, seed=0):
    """Realistic-motion clip: global pan over a textured background, two
    textured occluders on crossing trajectories (occluding the background
    and each other), a static high-texture strip (exercises stability
    tracking), colored chroma on the objects, and mild sensor noise.
    Returns planar bytes."""
    rng = np.random.default_rng(seed)
    hs, vs = (subsamp >> 2) & 3, subsamp & 3
    cw, ch = plane_dims(w, h, subsamp)

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
    """Raw planar clip bytes -> [(y, u, v), ...] uint8 arrays (views)."""
    cw, ch = plane_dims(w, h, subsamp)
    ysz, csz = w * h, cw * ch
    fsz = ysz + 2 * csz
    frames = []
    for i in range(n):
        f = np.frombuffer(yuv, np.uint8, fsz, i * fsz)
        frames.append((f[:ysz].reshape(h, w),
                       f[ysz:ysz + csz].reshape(ch, cw),
                       f[ysz + csz:].reshape(ch, cw)))
    return frames
