"""Benchmark of the PyTorch + CUDA port (`wavelet_monodepth_tpu_torch`).

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Everything a cell needs is found by name: its file under
`workloads/`, its configuration under `configs/`, the traffic driver under
`traffic/`, the configuration's adapter (`adapters/`), plain reference
(`reference/`) and work count (`work/`), the input generator under `gen/`
and each per-layer metric's reader under `metrics/`.
"""
