"""The benchmark of dsv1_tpu_torch: its harness, driven by BENCHMARK.json.

`run.py` (beside this package) is the command; everything that belongs
to one configuration, traffic mix, per-layer metric or work family sits
in a file of its own under `configs/`, `traffic/`, `metrics/` and
`work/`, found by the name BENCHMARK.json gives it. Nothing here
imports JAX or the JAX package; the program under test, dsv1_tpu_torch,
is imported only by `program.py`, and the plain references
(`reference/<name>/`: `dsvref`, unless a configuration names another)
import nothing of it.
"""
