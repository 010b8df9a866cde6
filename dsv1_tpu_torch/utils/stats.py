"""Counts of what the encode and decode paths did.

`STATS` (a Counter, like kernels/build.py `LAUNCHES`) is added to as the
paths run; callers set it to 0 with `STATS.clear()`. Keys:

- `core_i`, `core_p`: frames through the encode core as intra and as P
  (a forced-intra P slot counts as intra); a frame encoded twice counts
  twice;
- `hme_calls`, `hme_calls_wide`: `hme_batch` calls at effort 0 and at
  effort 1..3 (one per GOP of more than one frame on the GOP path, one
  per P frame on the sequential `Encoder`);
- `decode_p`: P pictures predicted by the decoders;
- `overflow_redos`: GOPs (gop 0: chunks; sequential: frames) whose
  compacted planes overflowed their caps and were packed from the dense
  planes instead;
- `calibration_gop`: under GOP-granular ABR, the GOP on which the rate
  model was calibrated (absent until it has been).

chip_smoke.py predicts each kernel's launches on a path from these.
"""

import collections

STATS = collections.Counter()
