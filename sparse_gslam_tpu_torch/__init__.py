"""sparse_gslam_tpu_torch — the PyTorch/CUDA port of sparse_gslam_tpu.

The JAX package `sparse_gslam_tpu` stays the reference; this package
keeps its layout (utils/ io/ ops/ models/ eval/, runner.py) and its
function names so each counterpart is easy to find, and imports nothing
of it. Host code is numpy; the landmark-graph LM solve runs as torch
ops on the chosen device (float64), and occupancy-grid ray insertion
is a hand-written CUDA kernel (csrc/insert_rays.cu) with a plain torch
twin used on the CPU.

Ported so far: the frontend-only path (`runner.py --no-backend`) with
its `.result` trajectory, relations ATE and the global occupancy map.
The loop-closing backend is not ported yet (see ROADMAP.md).
"""

__version__ = "0.1.0"
