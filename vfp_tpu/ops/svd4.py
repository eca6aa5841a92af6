"""Batched dominant singular triplet of tiny (4x4) matrices, batched.

The reference runs ``np.linalg.svd`` on every 4x4 DCT block — ~32k LAPACK
calls per 1080p frame (reference: src/offmark/embed/dwt_dct_svd_encoder.py:43,
extract/dwt_dct_svd_decoder.py:35).  The codec only ever *uses* the dominant
triplet (s0, u0, v0): embedding rewrites s0 and reconstructs
``B' = B + (s0' - s0) * u0 v0^T`` (the full SVD reconstruction
``u diag(s) v`` with only s0 changed is exactly that rank-1 update), and
extraction reads ``s0 % scale``.

Two batched methods over G = B^T B, both free of data-dependent control flow:

* ``jacobi`` (default): cyclic Jacobi eigensolver — a fixed number of sweeps
  of 6 Givens rotations.  Quadratically convergent and accurate for *all*
  spectra including near-tied singular values; pure elementwise work.
* ``power``: power iteration by repeated squaring — m normalized squarings
  give 2^m power steps as batched 4x4 matmuls.  Error decays
  like (lambda2/lambda1)^(2^m), so it is extremely accurate except for
  near-tied spectra.

Degenerate cases:
  * zero block: s0 = 0, u/v fall back to unit basis vectors (delta update is
    still valid: B + ds*u v^T has top singular value ds).
  * tied top singular values: any unit vector in the dominant eigenspace is a
    valid v0 (B v0 still has norm s0), so QIM parity is preserved.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST

# Deterministic start vector, deliberately non-symmetric so it is never exactly
# orthogonal to the dominant eigenvector of typical (e.g. DC-dominated) blocks.
_V0 = np.array([1.0, 0.93, 1.08, 1.02], dtype=np.float32)
_V0 /= np.linalg.norm(_V0)

_EPS = 1e-20


# ---------------------------------------------------------------------------
# Jacobi eigensolver (default)
# ---------------------------------------------------------------------------

def _jacobi_rotate(g, v, p, q):
    """One batched Givens rotation zeroing G[..., p, q] (and [q, p])."""
    apq = g[..., p, q]
    app = g[..., p, p]
    aqq = g[..., q, q]
    # Stable rotation: t = sign(tau) / (|tau| + sqrt(1 + tau^2))
    # <= so that apq == 0 is always "converged" (XLA flushes subnormal
    # thresholds to zero, making a strict < fail on all-zero rows).
    small = jnp.abs(apq) <= 1e-12 * (jnp.abs(app) + jnp.abs(aqq))
    tau = (aqq - app) / (2.0 * jnp.where(small, 1.0, apq))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(small, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c_ = c[..., None]
    s_ = s[..., None]
    # rows
    gp = c_ * g[..., p, :] - s_ * g[..., q, :]
    gq = s_ * g[..., p, :] + c_ * g[..., q, :]
    g = g.at[..., p, :].set(gp).at[..., q, :].set(gq)
    # cols
    gp = c_ * g[..., :, p] - s_ * g[..., :, q]
    gq = s_ * g[..., :, p] + c_ * g[..., :, q]
    g = g.at[..., :, p].set(gp).at[..., :, q].set(gq)
    # accumulate eigenvectors (columns of v)
    vp = c_ * v[..., :, p] - s_ * v[..., :, q]
    vq = s_ * v[..., :, p] + c_ * v[..., :, q]
    v = v.at[..., :, p].set(vp).at[..., :, q].set(vq)
    return g, v


def _jacobi_top_eigvec(g: jnp.ndarray, sweeps: int):
    """Dominant (eigenvector, eigenvalue) of symmetric [..., n, n] via Jacobi."""
    n = g.shape[-1]
    # Normalize magnitudes once for f32 health.
    scale = jnp.maximum(jnp.max(jnp.abs(g), axis=(-2, -1), keepdims=True), _EPS)
    gn = g / scale
    v = jnp.broadcast_to(jnp.eye(n, dtype=g.dtype), g.shape)
    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                gn, v = _jacobi_rotate(gn, v, p, q)
    eig = jnp.diagonal(gn, axis1=-2, axis2=-1)  # [..., n]
    k = jnp.argmax(eig, axis=-1)
    vtop = jnp.take_along_axis(v, k[..., None, None].repeat(n, axis=-2), axis=-1)[..., 0]
    lam = jnp.take_along_axis(eig, k[..., None], axis=-1)[..., 0] * scale[..., 0, 0]
    return vtop, jnp.maximum(lam, 0.0)


# ---------------------------------------------------------------------------
# Power iteration by repeated squaring (fast variant)
# ---------------------------------------------------------------------------

def _power_top_eigvec(g: jnp.ndarray, n_squarings: int) -> jnp.ndarray:
    for _ in range(n_squarings):
        norm = jnp.sqrt(jnp.sum(g * g, axis=(-2, -1), keepdims=True))
        g = g / jnp.maximum(norm, _EPS)
        g = jnp.einsum("...ij,...jk->...ik", g, g, precision=_HI)
    v0 = jnp.asarray(_V0[: g.shape[-1]])
    v = jnp.einsum("...ij,j->...i", g, v0, precision=_HI)
    vnorm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jnp.where(vnorm > _EPS, v / jnp.maximum(vnorm, _EPS), v0)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _top_v(b: jnp.ndarray, method: str, iters: int | None):
    g = jnp.einsum("...ji,...jk->...ik", b, b, precision=_HI)  # B^T B
    if method == "jacobi":
        v, _ = _jacobi_top_eigvec(g, sweeps=iters or 5)
    elif method == "power":
        v = _power_top_eigvec(g, n_squarings=iters or 6)
    else:
        raise ValueError(f"unknown svd method: {method}")
    return v


def top_singular_triplet(b: jnp.ndarray, method: str = "jacobi", iters: int | None = None):
    """[..., n, n] -> (s0 [...], u0 [..., n], v0 [..., n]) with B v0 = s0 u0."""
    v = _top_v(b, method, iters)
    bv = jnp.einsum("...ij,...j->...i", b, v, precision=_HI)
    s0 = jnp.linalg.norm(bv, axis=-1)
    e0 = jnp.zeros_like(v).at[..., 0].set(1.0)
    u = jnp.where(s0[..., None] > _EPS, bv / jnp.maximum(s0[..., None], _EPS), e0)
    return s0, u, v


def top_singular_value(b: jnp.ndarray, method: str = "jacobi", iters: int | None = None) -> jnp.ndarray:
    """[..., n, n] -> dominant singular value s0 [...]."""
    v = _top_v(b, method, iters)
    bv = jnp.einsum("...ij,...j->...i", b, v, precision=_HI)
    return jnp.linalg.norm(bv, axis=-1)
