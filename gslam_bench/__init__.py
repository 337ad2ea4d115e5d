"""Benchmark of sparse_gslam_tpu_torch, the PyTorch/CUDA port: one cell
(a configuration of the SLAM engine under one sensor-log traffic mix)
replayed for a fixed window on one CUDA card. `python -m gslam_bench.run
--help` runs a cell; BENCHMARK.json at the checkout's root lists them."""
