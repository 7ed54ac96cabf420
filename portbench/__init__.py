"""The benchmark of the PyTorch and CUDA port (``pctrans_torch``): one
command runs one cell (``python3 -m portbench.run --workload NAME --seed N
--seconds S --trace 0|1``); configurations, cells, entries and per-layer
metric readers are files found by name under this folder."""
