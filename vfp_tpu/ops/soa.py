"""Structure-of-arrays block layout for tiny-block math.

AoS layout ([B, N, 4, 4]) puts 4-wide dimensions innermost.  SoA keeps the
*block index* N minor:

    image [B, H, W] -> [B, 16, N]   (16 = flattened 4x4 block, N = #blocks)

so every per-block scalar op becomes an N-lane vector op, and the 2-D DCT
becomes one [16,16] x [B,16,N] matmul with the Kronecker matrix
D (x) D (vec(D A D^T) = (D (x) D) vec(A)).  The Jacobi eigensolver and the
QIM rank-1 update act on [B, 4, 4, N] / [B, 4, N] with static tiny indices
and lane-parallel arithmetic.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .dct import dct_matrix

_HI = jax.lax.Precision.HIGHEST
_EPS = 1e-20


# ---------------------------------------------------------------------------
# Layout transforms
# ---------------------------------------------------------------------------

def image_to_soa(img: jnp.ndarray, blk: int = 4) -> jnp.ndarray:
    """[B, H, W] (H, W multiples of blk) -> [B, blk*blk, N], blocks row-major."""
    b, h, w = img.shape
    nbh, nbw = h // blk, w // blk
    x = img.reshape(b, nbh, blk, nbw, blk)
    x = x.transpose(0, 2, 4, 1, 3)  # [B, blk, blk, nbh, nbw]
    return x.reshape(b, blk * blk, nbh * nbw)


def soa_to_image(x: jnp.ndarray, h: int, w: int, blk: int = 4) -> jnp.ndarray:
    """Inverse of :func:`image_to_soa`."""
    b = x.shape[0]
    nbh, nbw = h // blk, w // blk
    y = x.reshape(b, blk, blk, nbh, nbw)
    y = y.transpose(0, 3, 1, 4, 2)  # [B, nbh, blk, nbw, blk]
    return y.reshape(b, h, w)


# ---------------------------------------------------------------------------
# DCT via Kronecker matrix
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def dct_kron(n: int) -> np.ndarray:
    d = dct_matrix(n).astype(np.float64)
    return np.kron(d, d).astype(np.float32)  # [n*n, n*n]


def dct_soa(x: jnp.ndarray) -> jnp.ndarray:
    """[B, 16, N] spatial -> DCT coefficients (cv2.dct-compatible per block)."""
    n = int(round(x.shape[1] ** 0.5))
    k = jnp.asarray(dct_kron(n))
    return jnp.einsum("ij,bjn->bin", k, x, precision=_HI)


def idct_soa(x: jnp.ndarray) -> jnp.ndarray:
    n = int(round(x.shape[1] ** 0.5))
    k = jnp.asarray(dct_kron(n))
    return jnp.einsum("ji,bjn->bin", k, x, precision=_HI)


# ---------------------------------------------------------------------------
# Dominant singular triplet, SoA Jacobi
# ---------------------------------------------------------------------------

def _jacobi_rotate_soa(g, v, p, q):
    """Batched Givens rotation on G [B, 4, 4, N], V [B, 4, 4, N]."""
    apq = g[:, p, q]
    app = g[:, p, p]
    aqq = g[:, q, q]
    small = jnp.abs(apq) <= 1e-12 * (jnp.abs(app) + jnp.abs(aqq))
    tau = (aqq - app) / (2.0 * jnp.where(small, 1.0, apq))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(small, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c_ = c[:, None]  # broadcast over the row/col axis
    s_ = s[:, None]
    gp = c_ * g[:, p] - s_ * g[:, q]
    gq = s_ * g[:, p] + c_ * g[:, q]
    g = g.at[:, p].set(gp).at[:, q].set(gq)
    gp = c_ * g[:, :, p] - s_ * g[:, :, q]
    gq = s_ * g[:, :, p] + c_ * g[:, :, q]
    g = g.at[:, :, p].set(gp).at[:, :, q].set(gq)
    vp = c_ * v[:, :, p] - s_ * v[:, :, q]
    vq = s_ * v[:, :, p] + c_ * v[:, :, q]
    v = v.at[:, :, p].set(vp).at[:, :, q].set(vq)
    return g, v


# Deterministic non-symmetric start vector (never exactly orthogonal to the
# dominant eigenvector of typical DC-dominated blocks).
_V0 = np.array([1.0, 0.93, 1.08, 1.02], dtype=np.float32)
_V0 /= np.linalg.norm(_V0)


def top_triplet_soa(m: jnp.ndarray, method: str = "power", iters: int | None = None):
    """Dominant triplet of each 4x4 block in SoA layout.

    m: [B, 16, N] (entry r*4+c of block n).  Returns (s0 [B, N],
    u [B, 4, N], v [B, 4, N]) with B v = s0 u per block.

    method 'power' (default): repeated squaring of G = B^T B — iters
    squarings = 2^iters power steps of lane-parallel 4x4 matmuls; the fast
    memory-lean path (error decays like (l2/l1)^(2^iters)).
    method 'jacobi': cyclic Jacobi sweeps — tie-robust, slower.
    """
    b, sq, n = m.shape
    k = int(round(sq ** 0.5))
    x = m.reshape(b, k, k, n)  # [B, r, c, N]
    # G = B^T B: [B, c, d, N]
    g = jnp.einsum("bran,brdn->badn", x, x, precision=_HI)
    if method == "power":
        v0 = jnp.asarray(_V0[:k])
        for _ in range(iters or 5):
            norm = jnp.sqrt(jnp.sum(g * g, axis=(1, 2), keepdims=True))
            g = g / jnp.maximum(norm, _EPS)
            g = jnp.einsum("bikn,bkjn->bijn", g, g, precision=_HI)
        v = jnp.einsum("bijn,j->bin", g, v0, precision=_HI)
        vn = jnp.sqrt(jnp.sum(v * v, axis=1, keepdims=True))
        vtop = jnp.where(vn > _EPS, v / jnp.maximum(vn, _EPS), v0[None, :, None])
        bv = jnp.einsum("bran,ban->brn", x, vtop, precision=_HI)
        s0 = jnp.sqrt(jnp.sum(bv * bv, axis=1))
        e0 = jnp.zeros_like(bv).at[:, 0].set(1.0)
        u = jnp.where(s0[:, None] > _EPS, bv / jnp.maximum(s0[:, None], _EPS), e0)
        return s0, u, vtop
    sweeps = iters or 5
    scale = jnp.maximum(jnp.max(jnp.abs(g), axis=(1, 2), keepdims=True), _EPS)
    gn = g / scale
    v = jnp.broadcast_to(jnp.eye(k, dtype=m.dtype)[None, :, :, None], gn.shape)
    for _ in range(sweeps):
        for p in range(k):
            for q in range(p + 1, k):
                gn, v = _jacobi_rotate_soa(gn, v, p, q)
    eig = jnp.stack([gn[:, i, i] for i in range(k)], axis=1)  # [B, k, N]
    sel = jnp.argmax(eig, axis=1)  # [B, N]
    onehot = jax.nn.one_hot(sel, k, axis=1, dtype=m.dtype)  # [B, k, N]
    vtop = jnp.einsum("bckn,bkn->bcn", v, onehot, precision=_HI)  # [B, c(k), N]
    bv = jnp.einsum("bran,ban->brn", x, vtop, precision=_HI)  # [B, r, N]
    s0 = jnp.sqrt(jnp.sum(bv * bv, axis=1))  # [B, N]
    e0 = jnp.zeros_like(bv).at[:, 0].set(1.0)
    safe = jnp.maximum(s0[:, None], _EPS)
    u = jnp.where(s0[:, None] > _EPS, bv / safe, e0)
    return s0, u, vtop


def rank1_update_soa(m: jnp.ndarray, ds: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """m + ds * u v^T in SoA layout: m [B,16,N], ds [B,N], u/v [B,4,N]."""
    b, sq, n = m.shape
    k = u.shape[1]
    outer = u[:, :, None, :] * v[:, None, :, :]  # [B, r, c, N]
    return m + (ds[:, None] * outer.reshape(b, sq, n))
