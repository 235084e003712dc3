"""The benchmark of the PyTorch/CUDA port (`repro_torch`): `python3 -m
bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`,
driven by `BENCHMARK.json` and the files under this directory."""
