"""Counts of what the encode and decode paths did.

`STATS` (a Counter, like kernels/build.py `LAUNCHES`) is added to as the
paths run; callers set it to 0 with `STATS.clear()`. Keys:

- `core_i`, `core_p`: frames through the encode core as intra and as P
  (a forced-intra P slot counts as intra; padded frames of a tail chunk
  count); a frame encoded twice counts twice;
- `core_calls_i`, `core_calls_p`: calls of the encode core on intra and
  on P frames: a frame, or on the GOP path the frames of one type at
  one frame index of a chunk's GOPs (each call launches each kernel
  once);
- `chunks`: chunks of GOPs the GOP path encoded (gop > 0);
- `stab_carried`: GOPs whose I frame found the stability accumulators
  carried from the GOP before (the refresh counter between 0 and its
  period), which the JAX package encodes a second time;
- `hme_calls`, `hme_calls_wide`: `hme_batch` calls at effort 0 and at
  effort 1..3 (one per chunk of GOPs of more than one frame on the GOP
  path, one per P frame on the sequential `Encoder`);
- `decode_p`, `decode_p_calls`: P pictures predicted by the decoders,
  and the MC calls that predicted them (each a launch of the MC
  kernel: the GOP decoder's P pictures of one frame index of a chunk of
  chains on one device, or one picture of the sequential `Decoder`);
- `overflow_redos`: chunks of GOPs (gop 0: chunks of frames;
  sequential: frames) whose compacted planes overflowed their caps and
  were packed from the dense planes instead;
- `calibration_gop`: under GOP-granular ABR, the first GOP of the chunk
  on which the rate model was calibrated (absent until it has been).

chip_smoke.py predicts each kernel's launches on a path from these.
"""

import collections

STATS = collections.Counter()
