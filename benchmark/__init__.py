"""The benchmark of `psgd_tf_tpu_torch`: PSGD training steps on CUDA cards.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line last. Everything a cell needs is found by name: its configuration in
`configs/<config>.json`, its traffic in `traffic/<traffic>.json`, its
limits in `limits/<cell>.json`, the model's adapter in `models/<model>.py`
and its plain reference in `reference/<model>.py`, and every per-layer
metric in `metrics/<metric>.py`. Nothing here imports JAX or the JAX
package.
"""
