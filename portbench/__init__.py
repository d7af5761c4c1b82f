"""The benchmark of `mmnc_tpu_torch`, the PyTorch/CUDA codec, on one card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

runs one cell of `BENCHMARK.json` once: it makes the weights and the
inputs from the seed, sets up and warms up the cell's programs, measures
for `--seconds`, judges what the timed path produced against the plain
reference in `portbench/reference/` and prints one JSON line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by its name:
`configs/<config>.json`, `traffic/<traffic>.json` (read by the driver its
"driver" key names, `drivers/<driver>.py`), `limits/<cell>.json` (the
limits of the comparison that decides `correct`) and
`metrics/<metric>.py` (the reader of one per-layer metric). Nothing here
imports JAX or the JAX package `mmnc_tpu`; the reference imports nothing
of `mmnc_tpu_torch`.
"""
