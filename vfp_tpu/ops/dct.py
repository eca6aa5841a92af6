"""Orthonormal 2-D DCT-II on NxN blocks as two small matmuls.

Replaces the reference's per-block ``cv2.dct`` / ``cv2.idct`` calls
(reference: src/offmark/embed/dwt_dct_svd_encoder.py:43-45,
dct_encoder.py:29-37).  cv2.dct(A) == D @ A @ D.T with the orthonormal DCT-II
matrix D (verified numerically against cv2 in tests/test_ops.py), so a batch
of blocks becomes one einsum.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# QIM bins are sensitive to matmul precision: at default precision a GPU
# runs f32 einsums in TF32, flipping borderline bits.
_HI = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D (f32), rows = frequencies."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    d = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


def dct2(blocks: jnp.ndarray) -> jnp.ndarray:
    """[..., N, N] spatial blocks -> DCT-II coefficients (cv2.dct-compatible)."""
    d = jnp.asarray(dct_matrix(blocks.shape[-1]))
    return jnp.einsum("ij,...jk,lk->...il", d, blocks, d, precision=_HI)


def idct2(coeffs: jnp.ndarray) -> jnp.ndarray:
    """[..., N, N] DCT-II coefficients -> spatial blocks (cv2.idct-compatible)."""
    d = jnp.asarray(dct_matrix(coeffs.shape[-1]))
    return jnp.einsum("ji,...jk,kl->...il", d, coeffs, d, precision=_HI)
