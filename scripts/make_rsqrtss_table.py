"""Write sparse_gslam_tpu_torch/data/rsqrtss.hex from this CPU's rsqrtss.

    python scripts/make_rsqrtss_table.py [OUT]

The refinement's 20 / sqrt(n) starts, in XLA's CPU program, from the x86
rsqrtss approximation. On [1, 4) it depends only on the exponent's parity
and the top 10 mantissa bits, and rsqrtss(4 x) = rsqrtss(x) / 2, so 2 x
1024 entries give it for every float32 (ops/refine_exact.rsqrtss). The
entries are those of the floats with exponent p (0: [1, 2), 1: [2, 4))
and mantissa m << 13, as bits >> 11 in five hex digits, 16 to a line.
Compiles a small C program with gcc; x86 only.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "sparse_gslam_tpu_torch", "data", "rsqrtss.hex")
SOURCE = r"""
#include <immintrin.h>
#include <stdio.h>
#include <string.h>
int main(void) {
  for (unsigned q = 0; q < 2048; ++q) {
    const unsigned u = ((127u + (q >> 10)) << 23) | ((q & 1023u) << 13);
    float x, y;
    unsigned b;
    memcpy(&x, &u, 4);
    y = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x)));
    memcpy(&b, &y, 4);
    if (b & 0x7ffu) return 1; /* more than 12 significant bits */
    printf("%05x%s", b >> 11, q % 16 == 15 ? "\n" : "");
  }
  return 0;
}
"""


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rsq.c")
        exe = os.path.join(tmp, "rsq")
        with open(src, "w") as fh:
            fh.write(SOURCE)
        subprocess.run(["gcc", "-O2", "-o", exe, src], check=True)
        text = subprocess.run([exe], check=True, capture_output=True,
                              text=True).stdout
    with open(out, "w") as fh:
        fh.write(text)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
