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
- `core_calls_recon`: those of them that reconstructed their frames
  (all but gop 0's, whose frames are no reference);
- `chunks`: chunks of GOPs the GOP path encoded (gop > 0);
- `intra_chunks`: chunks of frames the intra-only path encoded (gop 0,
  `parallel/gop.py _encode_intra`; one frame a chunk at UHD);
- `stab_carried`: GOPs whose I frame found the stability accumulators
  carried from the GOP before (the refresh counter between 0 and its
  period), which the JAX package encodes a second time;
- `hme_calls`, `hme_calls_wide`: `hme_batch` calls at effort 0 and at
  effort 1..3 (one per chunk of GOPs of more than one frame on the GOP
  path, one per P frame on the sequential `Encoder`);
- `decode_calls`: the decoders' reconstructions of pictures of one
  type together (the GOP decoder's pictures of one type at one frame
  index of a chunk of chains on one device, or one picture of the
  sequential `Decoder`): each dequantizes and inverts every plane;
- `decode_p`, `decode_p_calls`: P pictures predicted by the decoders,
  and the MC calls that predicted them (each a launch of the MC
  kernel: the GOP decoder's P pictures of one frame index of a chunk of
  chains on one device, or one picture of the sequential `Decoder`);
- `overflow_redos`: chunks of GOPs (gop 0: chunks of frames;
  sequential: frames) whose compacted planes overflowed their caps and
  were packed from uncapped symbols instead (gop 0 and sequential: from
  the dense planes);
- `overflow_exact`, `overflow_syms`: of those chunks, the ones of the
  GOP path, whose every symbol ops/hzcc.py `compact_exact` listed on the
  device (one call each), and the symbols they read;
- `intra_dense_bytes`: of `d2h_bytes`, the bytes of the dense int32
  planes that gop 0 reads back for its overflowed chunks (the dense
  redo);
- `overflow_i`, `overflow_p`: of those chunks on the GOP path and at
  gop 0, the ones whose I planes overflowed their cap of large values
  (`nbig`) and the ones whose P planes overflowed their cap of (run,
  value) pairs (`p_ovf`); a chunk can count in both, and each chunk of
  the GOP path adds 0 to both where nothing overflowed;
- `host_reads`, `d2h_bytes`: blocking device-to-host reads through
  `utils/blob.py` `fetch` and `to_host`, and their bytes, counted on
  every device: on the GOP encode and decode paths each chunk's
  compacted and dense planes, the motion verdicts, the stability state
  at the end of an encode and the decoded planes (the sequential
  `Encoder`'s compacted reads and `Decoder`'s planes count too);
  `host_reads` also counts the per-frame ABR quality read (`.item()`,
  no bytes counted);
- `calibration_gop`: under GOP-granular ABR, the first GOP of the chunk
  on which the rate model was calibrated (absent until it has been).

chip_smoke.py predicts each kernel's launches on a path from these.
"""

import collections

STATS = collections.Counter()
