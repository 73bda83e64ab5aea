"""Host linear-algebra utilities with reference-parity semantics.

The reference's mod_linalg.f90 wraps LAPACK/MKL/ARPACK; the batched trainer
(reservoir.training) replaces the hot paths, but these direct equivalents
are kept for tooling/interop:
  mldivide : solve A^T X = B^T and return X^T (mod_linalg.f90:109-151 dgesv)
  pinv_svd : SVD pseudo-inverse (mod_linalg.f90:27-107 dgesvd)
Both accept an optional leading batch axis (the batched form).
"""

from __future__ import annotations

import numpy as np


def mldivide(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """X such that X @ A = B, computed as solve(A^T, B^T)^T in float64
    (the reference's Wout = mldivide(SS^T, SY^T) convention)."""
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(B, np.float64)
    return np.swapaxes(
        np.linalg.solve(np.swapaxes(A64, -1, -2), np.swapaxes(B64, -1, -2)),
        -1, -2)


def pinv_svd(A: np.ndarray, rcond: float = 1e-15) -> np.ndarray:
    """Moore-Penrose pseudo-inverse via SVD in float64."""
    return np.linalg.pinv(np.asarray(A, np.float64), rcond=rcond)
