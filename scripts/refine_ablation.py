"""Where the time of the port's CUDA scan refinement goes, on one GPU.

    python3 scripts/refine_ablation.py [--staging]

Builds a copy of sparse_gslam_tpu_torch/csrc/refine_pose.cu whose block
program stamps clock64() on thread 0 of block 0 after each barrier and
adds the cycles since the previous stamp to the phase the barrier ends:

    evaluate  the rows and Jacobian of every point at the trial pose
    reduce    the J^T J chains, the J^T r gemv, the sum-of-squares windows
    solve     thread 0: the cost's last levels, the accept test, the 3x3
              solve and the next trial's sinf/cosf
    other     the rest: the valid count, stage set-up, the covariance

and, for block sizes of 128, 256 and 512 threads (the header's
constexpr THREADS patched in each copy; the package builds 512), times
an unstamped copy and the stamped one on chip_smoke.py's seeded
refinement cases with rows in shared memory (N = 256 to 8192). Prints
one JSON line per (case, block size): cycles per launch of each phase,
the GN steps each stage ran and both copies' ms, then the card's name
and power limit. The six
copies are built with nvcc, all at once, under
sparse_gslam_tpu_torch/_build/ablation_refine/; their outputs are held
against the committed kernel's (torch.equal).

With --staging: the design choice for rows beyond shared memory (N >
8192, the header's SMEM_ROWS_MAX). Two copies at 512 threads, stamped
and unstamped: the committed one, whose reductions read the rows from a
ring of shared-memory slots that bulk asynchronous copies (TMA) fill,
and one with the header's STAGE_ROWS false, whose readers load the rows
from the global scratch themselves (plain global loads); timed on
chip_smoke.py's seeded cases from N = 16384 up, one JSON line per
(case, copy).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from sparse_gslam_tpu_torch.ops import grid_cuda, refine_cuda  # noqa: E402

OUT = os.path.join(grid_cuda.BUILD_DIR, "ablation_refine")
PHASES = ("evaluate", "reduce", "solve", "other")
THREAD_COUNTS = (128, 256, 512)
THREADS_LINE = "constexpr int THREADS = 512;"
STAGE_LINE = "constexpr bool STAGE_ROWS = true;"
REPS = 20
STAMPS = '''
__device__ unsigned long long rpx_phase_cycles[4];
#ifdef __CUDA_ARCH__
#define RPX_CLOCK() clock64()
#define RPX_STAMP(k)                                            \\
  {                                                             \\
    const long long t_ = clock64();                             \\
    if (threadIdx.x == 0 && blockIdx.x == 0)                    \\
      rpx_phase_cycles[k] += (unsigned long long)(t_ - rpx_last); \\
    rpx_last = t_;                                              \\
  }
#else
#define RPX_CLOCK() 0
#define RPX_STAMP(k)
#endif
'''
# (text of the header, stamped text): every occurrence is replaced
HEADER_SUBS = [
    ("namespace rpx {\n", STAMPS + "namespace rpx {\n"),
    ("  const Rows R{rows, column_stride(n)};\n",
     "  const Rows R{rows, column_stride(n)};\n"
     "  long long rpx_last = RPX_CLOCK();\n"),
    ("        if (kStaged) rows_written_fence();\n      });\n"
     "      ex.sync();\n      reduce(K, true);\n",
     "        if (kStaged) rows_written_fence();\n      });\n"
     "      ex.sync();\n      RPX_STAMP(0);\n      reduce(K, true);\n"
     "      RPX_STAMP(1);\n"),
    ("          gn_step(sh);\n        }\n      });\n      ex.sync();\n",
     "          gn_step(sh);\n        }\n      });\n      ex.sync();\n"
     "      RPX_STAMP(2);\n"),
    ("gn_step(sh);\n        }\n      });\n      ex.sync();\n      if (sh.done)",
     "gn_step(sh);\n        }\n      });\n      ex.sync();\n"
     "      RPX_STAMP(2);\n      if (sh.done)"),
    ("  ex.each([&](int tid) {\n    if (tid < 3) P.pose_out[tid]",
     "  RPX_STAMP(3);\n  ex.each([&](int tid) {\n    if (tid < 3) "
     "P.pose_out[tid]"),
]
ACCESS = '''
extern "C" int rpx_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(rpx_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, rpx_phase_cycles,
                                   4 * sizeof(unsigned long long));
}
'''


def patch(threads, stamped, staged=True):
    """A copy of the kernel's sources at `threads` threads a block (with
    the stamps when `stamped`; with `staged` False, STAGE_ROWS false);
    returns (directory, source)."""
    out = os.path.join(OUT, f"t{threads}{'' if staged else '_global'}"
                            f"{'_stamped' if stamped else ''}")
    os.makedirs(out, exist_ok=True)
    for f in grid_cuda.source_files(refine_cuda.SOURCE):
        shutil.copy(f, out)
    header = os.path.join(out, "refine_pose_exact.cuh")
    with open(header) as fh:
        text = fh.read()
    subs = [(THREADS_LINE, THREADS_LINE.replace("512", str(threads)))]
    if not staged:
        subs.append((STAGE_LINE, STAGE_LINE.replace("true", "false")))
    for old, new in subs + (HEADER_SUBS if stamped else []):
        if old not in text:
            raise RuntimeError(f"{old!r} is not in the kernel's header")
        text = text.replace(old, new)
    with open(header, "w") as fh:
        fh.write(text)
    src = os.path.join(out, os.path.basename(refine_cuda.SOURCE))
    if stamped:
        with open(src, "a") as fh:
            fh.write(ACCESS)
    return out, src


def build(variants):
    """Every copy's library, compiled at once: {(variant, stamped):
    (refine_pose_launch, rpx_phases or None)}; a variant is a thread
    count, or "global" (512 threads, STAGE_ROWS false)."""
    procs = {}
    for variant in variants:
        for stamped in (False, True):
            out, src = patch(512 if variant == "global" else variant,
                             stamped, staged=variant != "global")
            lib = os.path.join(out, "librefine_pose.so")
            procs[variant, stamped] = lib, subprocess.Popen(
                [grid_cuda._nvcc(), *refine_cuda.NVCC_FLAGS, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        cdll = ctypes.CDLL(lib)
        fn = cdll.refine_pose_launch
        fn.argtypes = refine_cuda._library().argtypes
        fn.restype = ctypes.c_int
        phases = None
        if key[1]:
            phases = cdll.rpx_phases
            phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
            phases.restype = ctypes.c_int
        fns[key] = fn, phases
    return fns


def launch(fn, stages, query, want_cov):
    """One launch of `fn` (refine_pose_launch's signature) on one
    problem: its outputs (pose, cov, probs) and steps."""
    pts, valid, init = (t[None].contiguous() for t in query)
    dev = pts.device
    out = (torch.empty((1, 3), device=dev), torch.empty((1, 3, 3), device=dev),
           torch.empty((1, pts.shape[1]), device=dev),
           torch.empty((1, 2), dtype=torch.int32, device=dev))
    (g0, o0, r0), (g1, o1, r1) = stages[0], stages[-1]
    rc = fn(g0.data_ptr(), g0.shape[0], o0.data_ptr(), ctypes.c_float(r0),
            g1.data_ptr(), g1.shape[0], o1.data_ptr(), ctypes.c_float(r1),
            len(stages), pts.data_ptr(), valid.view(torch.uint8).data_ptr(),
            init.data_ptr(), refine_cuda._y0(dev).data_ptr(), 1,
            pts.shape[1], 10, int(want_cov), *(t.data_ptr() for t in out),
            refine_cuda._ptr(refine_cuda._scratch(1, pts.shape[1], dev)),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def main() -> int:
    staging = "--staging" in sys.argv[1:]
    smi = chip_smoke.phase_device()[2]
    variants = (512, "global") if staging else THREAD_COUNTS
    fns = build(variants)
    cycles = torch.zeros(4, dtype=torch.int64)
    for case in chip_smoke.REFINE_CASES:
        kind, n, keys, seed = case[:4]
        if staging != refine_cuda.staged_rows(n):
            continue
        stages, query = chip_smoke.refine_case(kind, n, keys, seed)
        for want_cov in chip_smoke.refine_covs(case):
            ref, steps = chip_smoke.kernel_refine(stages, query,
                                                  want_cov=want_cov)
            steps = steps.tolist()
            for variant in variants:
                fn, _ = fns[variant, False]
                stamped, phases = fns[variant, True]
                equal = all(chip_smoke.refine_equal(
                    [t[0] for t in launch(f, stages, query, want_cov)
                     [:len(ref)]], ref) for f in (fn, stamped))
                phases(None, 1)
                for _ in range(REPS):
                    launch(stamped, stages, query, want_cov)
                torch.cuda.synchronize()
                rc = phases(cycles.data_ptr(), 0)
                if rc:
                    raise RuntimeError(f"reading the stamps: CUDA error {rc}")
                ms = chip_smoke.time_ms(
                    lambda: launch(fn, stages, query, want_cov), REPS)
                stamped_ms = chip_smoke.time_ms(
                    lambda: launch(stamped, stages, query, want_cov), REPS)
                per = (cycles.double() / REPS).tolist()
                chip_smoke.emit({
                    "case": f"{kind}_n{n}_{'+'.join(map(str, keys))}"
                            f"{'' if want_cov else '_pose_only'}",
                    "N": n, "threads": 512 if variant == "global" else variant,
                    "rows": ("global loads" if variant == "global" else
                             "ring" if refine_cuda.staged_rows(n)
                             else "shared"),
                    "steps": steps[:len(keys)],
                    "equal": equal,
                    "cycles": dict(zip(PHASES, per)),
                    "share": {p: c / sum(per) for p, c in zip(PHASES, per)},
                    "ms": ms, "stamped_ms": stamped_ms,
                })
                if not equal:
                    raise AssertionError(f"the {variant} copy differs "
                                         f"from the kernel on this case")
    print(smi)
    return 0

if __name__ == "__main__":
    sys.exit(main())
