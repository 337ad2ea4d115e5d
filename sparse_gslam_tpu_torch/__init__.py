"""sparse_gslam_tpu_torch — the PyTorch/CUDA port of sparse_gslam_tpu.

The JAX package `sparse_gslam_tpu` stays the reference; this package
keeps its layout (utils/ io/ ops/ models/ eval/, runner.py) and its
function names so each counterpart is easy to find, and imports nothing
of it. Host code is numpy; the landmark-graph LM and the pose-graph
Gauss-Newton run as float64 torch ops on the chosen device, the
correlative matcher and the scan refinement as float32 torch ops, and
occupancy-grid ray insertion is a hand-written CUDA kernel
(csrc/insert_rays.cu) with a plain torch twin used on the CPU.

Ported so far: the runner with and without the loop-closing backend
(the JAX package's CPU branch: submaps, pruned correlative matcher,
per-keyframe pins, chain edges, DCS pose graph), its `.result`
trajectory, relations ATE, closure precision/recall and the global
occupancy map. What is left is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
