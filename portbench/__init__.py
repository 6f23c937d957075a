"""The port's benchmark: one cell of BENCHMARK.json a run (`python3 -m portbench.run`).

Configurations, traffic mixes and per-layer metric readers live in files of
their own (`configs/`, `mixes/`, `metrics/`), found by the names in
BENCHMARK.json; `traffic.py` is the one generator, `counts.py` the
yardstick's arithmetic, `reference/` the plain reference the output check
holds the program to.
"""
