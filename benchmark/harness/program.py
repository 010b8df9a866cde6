"""The program under test, dsv1_tpu_torch, through its public entry
points: `encode_stream_gops` (on one device or a GOP mesh), the CLI's
`e` mode, `decode_stream_gops`. The only module of the harness that
imports it."""

from pathlib import Path


def encoder_config(mod, cfg: dict):
    """The EncoderConfig of a configuration's API settings (CRF at
    `quality_pct`, its `gop` and `effort`, defaults otherwise)."""
    return mod.EncoderConfig(quality=mod.quality_percent(cfg["quality_pct"]),
                             gop=cfg["gop"], effort=cfg["effort"])


def cli_args(cfg: dict, inp: Path, out: Path) -> list:
    """argv of a CLI encode from `inp` to `out` at the configuration's
    CLI arguments."""
    return ["e", f"-inp_{inp}", f"-out_{out}", *cfg["cli_args"], "-y"]


def stats():
    """The program's counters (`utils/stats.py STATS`)."""
    from dsv1_tpu_torch.utils.stats import STATS
    return STATS


class Program:
    """dsv1_tpu_torch on `devices` (one device, or a GOP mesh over all of
    them when the configuration asks for one)."""

    def __init__(self, cfg: dict, devices: list):
        import dsv1_tpu_torch as dt
        from dsv1_tpu_torch import cli
        self.dt, self.cli, self.stats = dt, cli, stats()
        self.cfg = cfg
        self.dev = devices[0]
        self.mesh = (dt.gop_mesh([str(d) for d in devices])
                     if cfg.get("mesh") == "gop_mesh" else None)
        self.meta = dt.Metadata(cfg["width"], cfg["height"], cfg["subsamp"])
        self.enc_cfg = (encoder_config(dt, cfg) if cfg["api"] == "gop"
                        else None)

    def encode(self, frames) -> bytes:
        return self.dt.encode_stream_gops(frames, self.meta, self.enc_cfg,
                                          self.dev, mesh=self.mesh)

    def cli_encode(self, inp: Path, out: Path) -> bytes:
        """The CLI's encode of a file; its output file's bytes."""
        if self.cli.main(cli_args(self.cfg, inp, out), device=self.dev) != 0:
            raise RuntimeError("the CLI's encode returned non-zero")
        return out.read_bytes()

    def decode(self, stream: bytes) -> list:
        """[(fno, [y, u, v]), ...] numpy planes in stream order."""
        return self.dt.decode_stream_gops(stream, self.dev,
                                          mesh=self.mesh)[1]
