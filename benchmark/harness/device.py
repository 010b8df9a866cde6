"""The cards a run uses: their names and count, and clocks and power
sampled by nvidia-smi beside the window."""

import shutil
import statistics
import subprocess

QUERY = ("index,name,clocks.sm,clocks.mem,power.draw,power.limit,"
         "temperature.gpu")


class Sampler:
    """nvidia-smi every 2 s while the window runs; `stop()` ends it and
    gives a line per card."""

    def __init__(self):
        self.proc = None
        exe = shutil.which("nvidia-smi")
        if exe:
            self.proc = subprocess.Popen(
                [exe, f"--query-gpu={QUERY}", "--format=csv,noheader,nounits",
                 "-lms", "2000"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> list:
        if self.proc is None:
            return ["nvidia-smi: not available"]
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = {}
        for line in out.splitlines():
            f = [x.strip() for x in line.split(",")]
            if len(f) == 7:
                rows.setdefault(f[0], []).append(f)
        lines = []
        for idx, rs in sorted(rows.items()):
            def col(i):
                return [float(r[i]) for r in rs
                        if r[i].replace(".", "", 1).isdigit()]
            sm, mem, pw, lim, temp = (col(i) for i in range(2, 7))
            lines.append(
                f"card {idx} {rs[0][1]}: {len(rs)} samples, sm clock MHz "
                f"min {min(sm, default=0)} median "
                f"{statistics.median(sm) if sm else 0} max "
                f"{max(sm, default=0)}, mem clock MHz "
                f"{statistics.median(mem) if mem else 0}, power W median "
                f"{statistics.median(pw) if pw else 0} max "
                f"{max(pw, default=0)} limit {max(lim, default=0)}, "
                f"temperature C max {max(temp, default=0)}")
        return lines or ["nvidia-smi: no samples"]
