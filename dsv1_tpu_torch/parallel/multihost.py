"""GOP-sharded encode across processes (mirror of
dsv1_tpu/parallel/multihost.py, on torch.distributed).

Closed GOPs with a metadata packet at every GOP start
(dsv_encoder.c:624-652) make contiguous GOP ranges independent under
CRF: each process encodes its own range of GOPs from its own frames,
and the only state that crosses a range boundary is the prev-link of the
boundary picture (dsv_encoder.c:170-192), patched in O(1) at mux time,
and the stability accumulators, when the boundary does not fall on a
stability refresh. The muxed stream is byte-identical to a one-process
encode of the whole sequence.

    shard = encode_shard(my_frames, meta, cfg, first_gop=g0)
    # gather the EncodedShard parts on one process (any transport), then
    stream = mux_shards(parts, meta)

`shard_ranges` splits a sequence into per-process GOP ranges;
`encode_stream_multihost` runs every shard in one process, one after
another; `run_distributed_shard` is one rank of the real flow on
torch.distributed (gloo), with the ranks' stability handshake.
"""

import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np

from ..constants import GOP_INTRA, RATE_CONTROL_CRF, div_round
from ..models.bitstream import encode_eos_packet, encode_metadata_packet
from ..models.encoder import EncoderConfig, block_geometry
from ..models.metadata import Metadata
from .gop import encode_stream_gops
from .mesh import Mesh

# byte offset of the prev-link field in a packet header (B.1)
_PREV_OFF = 6
# how long a rank's collective waits for the others (their encodes and
# the handshake's encodes again run between two collectives)
_GLOO_TIMEOUT = timedelta(minutes=5)


@dataclass
class EncodedShard:
    """One process's partial stream: its GOP range's packets, no EOS."""
    data: bytes
    last_pic_len: int   # prev-link seed for the next shard's first picture
    first_gop: int
    # the stability state after the shard ((nblk, 2) int32, refresh
    # counter): the next shard's stab_init where the boundary does not
    # fall on a stability refresh
    stab_final: tuple | None = None


def shard_ranges(n_frames: int, gop: int, n_shards: int):
    """Split n_frames into n_shards contiguous GOP ranges:
    [(first_gop, first_frame, frames in the shard)]; with more shards
    than GOPs the last shards get no frames."""
    G = max(gop, 1) if gop != GOP_INTRA else 1
    ngops = div_round(n_frames, G)
    per = div_round(ngops, n_shards)
    out = []
    for s in range(n_shards):
        g0 = min(s * per, ngops)
        g1 = min(g0 + per, ngops)
        f0 = g0 * G
        f1 = min(g1 * G, n_frames)
        out.append((g0, f0, max(f1 - f0, 0)))
    return out


def encode_shard(frames, meta: Metadata, cfg: EncoderConfig, first_gop: int,
                 gops_per_device: int = 0, stab_init: tuple | None = None,
                 device="cuda", mesh: Mesh | None = None) -> EncodedShard:
    """Encode one process's GOP range. frames must start at a GOP
    boundary (frame number first_gop * cfg.gop). CRF only, as in the JAX
    package.

    stab_init: the previous shard's stab_final. With it the shard is
    byte-identical to its slice of a one-process encode in every case;
    without it the shard assumes that its first GOP starts at a
    stability refresh, which holds whenever the boundary falls on one
    (the CLI default stable_refresh = gop - 1, unless a forced-intra
    frame moved the refresh in the previous shard's last GOPs). With a
    GOP mesh (its devices take `device`'s place) the shard's GOPs are
    split over it, as in encode_stream_gops."""
    if cfg.rc_mode != RATE_CONTROL_CRF:
        raise ValueError("multi-host GOP sharding requires CRF")
    G = max(cfg.gop, 1) if cfg.gop != GOP_INTRA else 1
    data, last, stab = encode_stream_gops(
        frames, meta, cfg, device, gops_per_device, mesh=mesh,
        _fnum_base=first_gop * G, _emit_eos=False, _return_state=True,
        _stab_init=stab_init)
    return EncodedShard(data=data, last_pic_len=last, first_gop=first_gop,
                        stab_final=stab)


def _patch_first_prev(data: bytearray, meta_len: int, prev_link: int):
    """Patch the prev-link of the shard's first picture packet (it sits
    right after the leading metadata packet)."""
    off = meta_len + _PREV_OFF
    if len(data) >= off + 4:
        data[off:off + 4] = prev_link.to_bytes(4, "big")


def mux_shards(parts, meta: Metadata) -> bytes:
    """Concatenate partial streams into one .dsv stream: the boundary
    prev-link patches and the final EOS packet."""
    parts = sorted((p for p in parts if p.data), key=lambda p: p.first_gop)
    meta_len = len(encode_metadata_packet(meta))
    out = bytearray()
    prev = 0
    for p in parts:
        d = bytearray(p.data)
        _patch_first_prev(d, meta_len, prev)
        out += d
        prev = p.last_pic_len
    out += encode_eos_packet(prev)
    return bytes(out)


def encode_stream_multihost(frames, meta: Metadata,
                            cfg: EncoderConfig | None = None,
                            n_shards: int = 2, device="cuda",
                            mesh: Mesh | None = None) -> bytes:
    """Every shard of the multi-process flow in this process, one after
    another (each carrying the previous shard's stability state, each
    over `mesh` where one is given), then the mux: byte-identical to
    encode_stream_gops over the whole sequence."""
    cfg = cfg or EncoderConfig()
    frames = list(frames)
    parts = []
    stab = None
    for g0, f0, nf in shard_ranges(len(frames), cfg.gop, n_shards):
        if nf == 0:
            continue
        parts.append(encode_shard(frames[f0:f0 + nf], meta, cfg,
                                  first_gop=g0, stab_init=stab,
                                  device=device, mesh=mesh))
        stab = parts[-1].stab_final
    return mux_shards(parts, meta)


def _all_gather(dist, arr: np.ndarray) -> np.ndarray:
    """Every rank's int64 array of the same shape, stacked by rank."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(arr, np.int64))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def run_distributed_shard(coordinator: str, num_processes: int,
                          process_id: int, frames_all, meta: Metadata,
                          cfg: EncoderConfig, out_path=None,
                          device="cuda", mesh: Mesh | None = None):
    """One rank of the multi-process encode on torch.distributed (gloo,
    `tcp://coordinator`, e.g. "127.0.0.1:29500"): each rank encodes its
    GOP range (`shard_ranges`) at once from zeroed stability
    accumulators; then the ranks swap their final stability states, and a
    rank whose predecessor did not end at a stability refresh encodes
    again from the carried state, until no rank changes (at most
    num_processes - 1 rounds; none where every boundary falls on a
    refresh, as with the CLI default stable_refresh = gop - 1). The
    shards are gathered by length, then as padded bytes, and rank 0 muxes
    them: byte-identical to a one-process encode.

    frames_all: the whole sequence (each rank encodes only its range);
    mesh: the rank's own GOP mesh (its devices take `device`'s place).
    On a GPU the kernels are built before the process group starts, so a
    rank's first build does not hold up the others' collectives.
    Returns (the muxed stream on rank 0, else None; (encode seconds,
    handshake rounds, mux seconds)); rank 0 also writes the stream to
    out_path if one is given. The process group is destroyed on the way
    out."""
    import torch
    import torch.distributed as dist

    from ..device import resolve
    if (resolve(device) if mesh is None
            else mesh.devices.reshape(-1)[0]).type == "cuda":
        from ..kernels.build import lib
        lib()
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=_GLOO_TIMEOUT)
    try:
        ranges = shard_ranges(len(frames_all), cfg.gop, num_processes)
        g0, f0, nf = ranges[process_id]
        nbh, nbv = block_geometry(meta.width, meta.height)[2:]
        nblk = nbh * nbv
        G = max(cfg.gop, 1) if cfg.gop != GOP_INTRA else 1
        sr = cfg.stable_refresh or max(1, min(G - 1, 14))

        def encode(init=None):
            return (encode_shard(frames_all[f0:f0 + nf], meta, cfg, g0,
                                 stab_init=init, device=device, mesh=mesh)
                    if nf else None)

        def stab_row(sh):
            if sh is None:
                return np.zeros(nblk * 2 + 1, np.int64)
            return np.concatenate([np.asarray(sh.stab_final[0]).reshape(-1),
                                   [sh.stab_final[1]]]).astype(np.int64)

        t0 = time.perf_counter()
        shard = encode()
        enc_s = time.perf_counter() - t0

        # optimistic handshake: a fixed point over the carried states
        my_init = np.zeros(nblk * 2 + 1, np.int64)
        rounds = 0
        while True:
            rows = _all_gather(dist, stab_row(shard))
            want = np.zeros_like(my_init)
            if process_id > 0 and nf:
                prev = rows[process_id - 1]
                if 0 < int(prev[-1]) < sr:
                    want = prev
            changed = not np.array_equal(want, my_init)
            if not _all_gather(dist, np.asarray([changed])).any():
                break
            rounds += 1
            if changed:
                my_init = want
                t0 = time.perf_counter()
                shard = encode((my_init[:-1].reshape(nblk, 2)
                                .astype(np.int32), int(my_init[-1])))
                enc_s += time.perf_counter() - t0

        # gather the shards: lengths first, then the padded bytes
        data = (np.frombuffer(shard.data, np.uint8) if shard
                else np.zeros(0, np.uint8))
        lens = _all_gather(dist, np.asarray(
            [data.size, shard.last_pic_len if shard else 0]))
        padded = np.zeros(max(1, int(lens[:, 0].max())), np.uint8)
        padded[:data.size] = data
        t = torch.from_numpy(padded)
        alldata = [torch.empty_like(t) for _ in range(num_processes)]
        dist.all_gather(alldata, t)

        stream, mux_s = None, 0.0
        if process_id == 0:
            t0 = time.perf_counter()
            parts = [EncodedShard(alldata[r][:int(lens[r, 0])].numpy()
                                  .tobytes(), int(lens[r, 1]),
                                  first_gop=ranges[r][0])
                     for r in range(num_processes) if int(lens[r, 0])]
            stream = mux_shards(parts, meta)
            mux_s = time.perf_counter() - t0
            if out_path is not None:
                with open(out_path, "wb") as f:
                    f.write(stream)
        return stream, (enc_s, rounds, mux_s)
    finally:
        dist.destroy_process_group()
