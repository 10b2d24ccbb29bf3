"""Chi-square gating table (the port's copy of plviwo_tpu/ops/chi2.py:17-19).

The 0.95 quantile for dof 1..MAX_DOF, computed once at import with
`scipy.stats.chi2.ppf`; entry 0 is unused.  The port imports nothing of the
JAX package, so it keeps its own copy; tests/test_torch_fused_frame.py holds
the two tables equal.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as _stats

MAX_DOF = 2048

_TABLE = np.zeros(MAX_DOF + 1)
_TABLE[1:] = _stats.chi2.ppf(0.95, np.arange(1, MAX_DOF + 1))
