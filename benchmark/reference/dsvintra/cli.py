"""The command-line encoder of dsvintra: `-gop0 -rc_mode1` (intra only,
CRF) encodes through this package, one frame after another as read from
the file; every other argument list is dsvref's CLI, whose parameter
table and argument parsing this one shares.

    main(["e", "-inp_in.yuv", "-out_out.dsv", "-w3840", "-h2160",
          "-gop0", "-rc_mode1", "-y"])
"""

import sys

from dsvref import cli as gop_cli
from dsvref.constants import GOP_INTRA, RATE_CONTROL_CRF
from dsvref.utils.yuv import read_frame

from .intra import encode_stream_gops


def encode_intra_main(argv, device="cuda"):
    """The encode of `argv` (the options after "e") where it asks for gop
    0 under CRF: 0 when written, 1 on bad arguments; None for any other
    encode."""
    params = gop_cli.enc_params()
    opts = gop_cli._parse(argv, params)
    if opts is None or not opts["inp"] or not opts["out"]:
        print("bad arguments, or inp or out not specified")
        return 1
    meta, cfg = gop_cli._config(params)
    if cfg.gop != GOP_INTRA or cfg.rc_mode != RATE_CONTROL_CRF:
        return None
    first = gop_cli._get(params, "sfr")
    nfr = gop_cli._get(params, "nfr")
    end = first + nfr if nfr > 0 else -1

    def frames(f):
        fno = first
        while end <= 0 or fno < end:
            planes = read_frame(f, fno, meta.width, meta.height,
                                meta.subsamp)
            if planes is None:
                return
            fno += 1
            yield planes

    with open(opts["inp"], "rb") as f:
        out = encode_stream_gops(frames(f), meta, cfg, device)
    with open(opts["out"], "wb") as f:
        f.write(out)
    return 0


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0][:1] == "e":
        rc = encode_intra_main(argv[1:], device)
        if rc is not None:
            return rc
    return gop_cli.main(argv, device)


if __name__ == "__main__":
    sys.exit(main())
