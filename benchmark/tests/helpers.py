"""Small runs of the harness on the CPU: a cell's configuration cut to a
160x128 frame, 24 frames at most and a pool of two clips, the program
and the reference on CPU tensors (their plain PyTorch versions)."""

import time

import torch

from harness import cell, spec

SEED = 2**40 + 7   # larger than 32 bits: a run takes any seed up to past 2**31


def small(name: str):
    """(config, traffic) of cell `name` at 160x128, segments of at most
    24 frames, a pool of two."""
    bench = spec.load()
    w = spec.workload(bench, name)
    cfg = spec.config(bench, w["config"])
    tr = spec.traffic(w["traffic"])
    cfg.update(width=160, height=128,
               segment_frames=min(cfg["segment_frames"], 24))
    if cfg["api"] == "cli":
        cfg["cli_args"] = ["-w160", "-h128"]
    tr["pool"] = 2
    return cfg, tr, w["chips"]


def run_small(name: str, traced: bool = False, seconds: int = 0,
              cfg_keys: dict | None = None):
    """One run of the harness (one request when seconds is 0, the traced
    slice when traced) on the CPU, with `cfg_keys` set in the cut
    configuration; the result line's object."""
    torch.set_num_threads(2)
    cfg, tr, chips = small(name)
    cfg.update(cfg_keys or {})
    devices = [torch.device("cpu")] * chips
    return cell.run(name, SEED, seconds, traced, devices,
                    time.perf_counter(), cfg=cfg, tr=tr, say=lambda s: None)
