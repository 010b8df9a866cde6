"""Runs chip_smoke.py's mesh phase (10) with its mesh entries on every
visible CUDA card instead of one card listed several times.

    python3 tools/torch_mesh_cards.py

With four cards: the GOP mesh on cuda:0 and cuda:1, the column tiles and
the gop x tile meshes on cuda:0..3, so neighbour columns, gathered tails
and each row's work cross cards, and every kernel wrapper launches on
its tensors' card. Each stream and decode is held to its golden and
each tiled transform to the untiled one, with launches as predicted.
It checks correctness across cards: the frames/s and times the phase
prints come from small clips, one run each, and measure no scaling.
Prints one JSON line per check, then the cards' names and power
limits.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_cards: needs CUDA devices")
    import chip_smoke as cs
    from dsv1_tpu_torch.utils import golden as g
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    smi, _clock = cs.phase_device()
    cs.phase_build()
    golden = g.load()
    clips = {n: g.clip_frames(n)
             for n in ("cif", "1080p", "cif_batch", "1080p_gopabr_batch")}
    errs, launches = cs.phase_mesh(cards[0], smi, golden, clips, cards)
    print(json.dumps({"cards": [str(c) for c in cards], "max_abs_err": errs,
                      "launches": launches, "ok": not any(errs.values())}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
