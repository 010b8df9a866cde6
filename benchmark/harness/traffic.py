"""The one traffic generator: a traffic mix's parameters
(traffic/<name>.json) and a configuration's frame size make, from the
seed, a pool of distinct clips and the order in which a closed loop of
one client takes them. Every seed gives the same sizes and the same
number of requests a clip; only the pictures and the order differ."""

import numpy as np

from .corpus import make_rich_clip, split_frames


def pool(cfg: dict, tr: dict, seed: int) -> list:
    """The pool's clips as raw planar bytes, `segment_frames` frames of
    the configuration's size each."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**63 - 1, tr["pool"], dtype=np.int64)
    return [make_rich_clip(cfg["width"], cfg["height"], cfg["subsamp"],
                           cfg["segment_frames"], seed=int(s))
            for s in seeds]


def frames(cfg: dict, clip: bytes) -> list:
    return split_frames(clip, cfg["width"], cfg["height"], cfg["subsamp"],
                        cfg["segment_frames"])


def order(tr: dict, seed: int) -> list:
    """The pool cycled in a seed-drawn order: request i takes clip
    order[i % pool]."""
    rng = np.random.default_rng([seed, 1])
    return [int(k) for k in rng.permutation(tr["pool"])]


def kept(tr: dict, seed: int) -> set:
    """Request indices whose answers are kept for the comparison: all
    when the mix names no `compare_sample`, else the first request and
    compare_sample - 1 more drawn from the seed among the next
    `compare_within`."""
    n = tr.get("compare_sample")
    if n is None:
        return None
    rng = np.random.default_rng([seed, 2])
    more = rng.choice(np.arange(1, tr["compare_within"]), n - 1,
                      replace=False)
    return {0, *(int(k) for k in more)}
