"""A run of each cell's kind on the CPU, its look for a chip skipped,
comes out correct; with the timed path broken underneath, each fault the
cell can have makes it come out not correct: a step that returns its
state unchanged, half of a request's frames left out, an answer altered
where it is produced."""

import pytest

import helpers


def state_unchanged(mp, op):
    """Encode: the reconstruction never written, so every P frame is
    predicted from a reference that keeps its old state. Decode: each
    frame index leaves the chains' reference images as they were."""
    if op == "encode":
        from dsv1_tpu_torch.ops import sbt
        mp.setattr(sbt, "inv_sbt_recon", lambda *a, **k: None)
    else:
        from dsv1_tpu_torch.parallel.decode import GopDecoder
        frame = GopDecoder.frame

        def stale(self, st, k):
            refs = st.refs
            frame(self, st, k)
            st.refs = refs
        mp.setattr(GopDecoder, "frame", stale)


def half_left_out(mp, op):
    """Half of each request's frames dropped on the program's side."""
    import dsv1_tpu_torch as dt
    from dsv1_tpu_torch import cli
    if op == "encode":
        enc = dt.encode_stream_gops

        def half(frames, *a, **k):
            frames = list(frames)
            return enc(frames[:len(frames) // 2], *a, **k)
        mp.setattr(dt, "encode_stream_gops", half)
        mp.setattr(cli, "encode_stream_gops", half)
    else:
        dec = dt.decode_stream_gops

        def half(stream, *a, **k):
            meta, frames = dec(stream, *a, **k)
            return meta, frames[:len(frames) // 2]
        mp.setattr(dt, "decode_stream_gops", half)


def answer_altered(mp, op):
    """Encode: one byte of each packed chunk flipped. Decode: one sample
    of each chunk's decoded planes changed."""
    if op == "encode":
        from dsv1_tpu_torch.parallel.gop import ChunkOutput
        pack = ChunkOutput.pack

        def flipped(self, *a, **k):
            pkt, link = pack(self, *a, **k)
            pkt = bytearray(pkt)
            pkt[-1] ^= 0x5A
            return bytes(pkt), link
        mp.setattr(ChunkOutput, "pack", flipped)
    else:
        from dsv1_tpu_torch.parallel.decode import GopDecoder
        finish = GopDecoder.finish

        def altered(self, st):
            out = finish(self, st)
            y = out[0][0][0]
            y[0, 0] ^= 1
            return out
        mp.setattr(GopDecoder, "finish", altered)


CELLS = {"crf_1080p.encode": "encode", "abr_4k_cli.encode": "encode",
         "crf_1080p.decode": "decode"}
FAULTS = [(c, f) for c in CELLS for f in (state_unchanged, half_left_out,
                                          answer_altered)]


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    out = helpers.run_small(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["limit"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, CELLS[cell])
    out = helpers.run_small(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_traced_run(cell):
    """A traced run reports per-layer metrics only, each one the cell
    lists, with the slice's device fields and breakdown beside."""
    from harness import spec
    out = helpers.run_small(cell, traced=True)
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in spec.metrics(spec.load(), cell, True)}
    assert out["metrics"] and set(out["metrics"]) <= listed
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"
