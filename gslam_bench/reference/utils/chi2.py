"""Chi-squared quantiles for consistency gating.

The reference gates data association with boost::math
quantile(chi_squared(dof), 0.99) (src/drone.cpp:14,167) and prunes loop
closures at chi2 > 11.345 = chi2(3).ppf(0.99) (src/log_runner.cpp:184).
We use scipy when available and the Wilson-Hilferty approximation as a
dependency-free fallback (accurate to <0.5% for dof >= 3).
Port of sparse_gslam_tpu/utils/chi2.py.
"""
from __future__ import annotations

import math

try:
    from scipy.stats import chi2 as _scipy_chi2
except Exception:  # pragma: no cover
    _scipy_chi2 = None

# z-quantiles of the standard normal for common confidence levels
_Z = {0.99: 2.3263478740408408, 0.95: 1.6448536269514722}


def chi2_quantile(p: float, dof: float) -> float:
    if dof <= 0:
        return 0.0
    if _scipy_chi2 is not None:
        return float(_scipy_chi2.ppf(p, dof))
    z = _Z.get(p)
    if z is None:
        raise ValueError(f"unsupported confidence level {p} without scipy")
    # Wilson-Hilferty: chi2_p(k) ~ k (1 - 2/(9k) + z sqrt(2/(9k)))^3
    k = float(dof)
    return k * (1.0 - 2.0 / (9.0 * k) + z * math.sqrt(2.0 / (9.0 * k))) ** 3
