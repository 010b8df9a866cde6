"""Counts of what the encode and decode paths did (the program's
`utils/stats.py` keys, as far as the paths copied here count them).

`STATS` (a Counter) is added to as the paths run; callers set it to 0
with `STATS.clear()`. Keys:

- `core_i`, `core_p`: frames through the encode core as intra and as P
  (a forced-intra P slot counts as intra; padded frames of a tail chunk
  count); a frame encoded twice counts twice;
- `core_calls_i`, `core_calls_p`: calls of the encode core on intra and
  on P frames: the frames of one type at one frame index of a chunk's
  GOPs;
- `core_calls_recon`: those of them that reconstructed their frames;
- `chunks`: chunks of GOPs encoded;
- `stab_carried`: GOPs whose I frame found the stability accumulators
  carried from the GOP before (the refresh counter between 0 and its
  period), which the JAX package encodes a second time;
- `hme_calls`, `hme_calls_wide`: `hme_batch` calls at effort 0 and at
  effort 1..3 (one per chunk of GOPs of more than one frame);
- `decode_calls`: the decoder's reconstructions of pictures of one type
  at one frame index of a chunk of chains: each dequantizes and
  inverts every plane;
- `decode_p`, `decode_p_calls`: P pictures predicted by the decoder,
  and the MC calls that predicted them;
- `overflow_redos`: chunks of GOPs whose compacted planes overflowed
  their caps and were packed from the dense planes instead.
"""

import collections

STATS = collections.Counter()
