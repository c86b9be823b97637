"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell once (``python gpubench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``).  Cells, configurations,
drivers and per-layer metrics are files found by name."""
