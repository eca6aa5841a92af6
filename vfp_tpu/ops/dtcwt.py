"""2-D dual-tree complex wavelet transform (DT-CWT) in JAX.

The reference uses the ``dtcwt`` package's Transform2d/Pyramid
(reference: src/offmark/embed/dtcwt_key_encoder.py:13-26,
extract/dtcwt_key_decoder.py:13-38).  That package is pure NumPy and
unavailable here, so this is a ground-up implementation with the same
*semantics* the codecs rely on:

* ``forward(x, nlevels)`` -> Pyramid with ``highpasses[lev]`` of shape
  [..., H/2^(lev+1), W/2^(lev+1), 6] complex64 (6 directional subbands) and
  an interleaved real ``lowpass`` of twice the final highpass dims.
* ``inverse(Pyramid)`` reconstructs exactly (PR verified in tests), including
  the decoders' 1-level pyramid with a zero lowpass.

Design choices (documented deviations — the system is self-consistent, and
no dtcwt-marked media exists to interoperate with):

* circular (periodic) signal extension instead of symmetric — makes perfect
  reconstruction *exact* for any filter pair; differs from the package only
  in boundary coefficients.
* level 1: LeGall 5/3 biorthogonal pair (exact rational PR filters), tree B
  = one-sample-delayed sampling phase.
* levels >= 2: an even-length orthonormal q-shift filter designed numerically
  (tools/design_dtcwt.py) for ~1/4-sample group delay; tree B = time reverse.
* the 6 subbands are the unitary (q2c) combinations of the 4 row/col tree
  mixes of LH/HL/HH; ordering [LH+, LH-, HL+, HL-, HH+, HH-].

Everything is batched over leading axes and jit-friendly (static shapes,
no data-dependent control flow).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import dtcwt_coeffs as C


# ---------------------------------------------------------------------------
# 1-D circular filter bank primitives (last axis)
# ---------------------------------------------------------------------------

def _corr_valid(x: jnp.ndarray, w: np.ndarray, stride: int) -> jnp.ndarray:
    """VALID correlation along the last axis, arbitrary leading dims."""
    lead = x.shape[:-1]
    n = x.shape[-1]
    xr = x.reshape(-1, 1, n)
    rhs = jnp.asarray(w, x.dtype).reshape(1, 1, -1)
    out = jax.lax.conv_general_dilated(
        xr, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "IOH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(*lead, -1)


def _circ_window(x: jnp.ndarray, start: int, length: int) -> jnp.ndarray:
    """x tiled circularly, then [start : start + length] with start possibly
    negative — works for any filter length vs signal length."""
    n = x.shape[-1]
    reps = (abs(start) // n + 1) + (start + length) // n + 1
    base = (abs(start) // n + 1) * n
    xt = jnp.concatenate([x] * reps, axis=-1)
    return jax.lax.slice_in_dim(xt, base + start, base + start + length, axis=-1)


def down2(x: jnp.ndarray, f: np.ndarray, phase: int) -> jnp.ndarray:
    """y[m] = sum_k f[k] * x[(2m + phase - k) mod N]; [..., N] -> [..., N/2]."""
    n = x.shape[-1]
    L = len(f)
    xp = _circ_window(x, phase - (L - 1), n + L - 1)
    return _corr_valid(xp, np.asarray(f)[::-1].copy(), 2)


def up2(y: jnp.ndarray, f: np.ndarray, phase: int) -> jnp.ndarray:
    """x[n] = sum_k f[k] * y2[(n - k) mod N], y2 = zeros; y2[phase::2] = y."""
    n2 = y.shape[-1]
    n = 2 * n2
    L = len(f)
    y2 = jnp.zeros((*y.shape[:-1], n), y.dtype).at[..., phase::2].set(y)
    yp = _circ_window(y2, -(L - 1), n + L - 1)
    return _corr_valid(yp, np.asarray(f)[::-1].copy(), 1)


def _along_rows(fn, x, *args):
    """Apply a last-axis op along axis -2."""
    return jnp.swapaxes(fn(jnp.swapaxes(x, -1, -2), *args), -1, -2)


# ---------------------------------------------------------------------------
# Per-tree 2-D analysis / synthesis (one level)
# ---------------------------------------------------------------------------

def _analysis2d(x, h0, h1, row_phase, col_phase):
    """One 2-D DWT level -> (ll, lh, hl, hh), each [..., H/2, W/2]."""
    lo = _along_rows(down2, x, h0, row_phase)
    hi = _along_rows(down2, x, h1, row_phase)
    ll = down2(lo, h0, col_phase)
    lh = down2(lo, h1, col_phase)
    hl = down2(hi, h0, col_phase)
    hh = down2(hi, h1, col_phase)
    return ll, lh, hl, hh


def _synthesis2d(ll, lh, hl, hh, g0, g1, row_phase, col_phase, roll_r, roll_c):
    lo = up2(ll, g0, col_phase) + up2(lh, g1, col_phase)
    hi = up2(hl, g0, col_phase) + up2(hh, g1, col_phase)
    x = _along_rows(up2, lo, g0, row_phase) + _along_rows(up2, hi, g1, row_phase)
    x = jnp.roll(x, roll_c, axis=-1)
    return jnp.roll(x, roll_r, axis=-2)


# ---------------------------------------------------------------------------
# q2c / c2q: 4 real tree-mix subbands <-> 2 complex directional subbands
# ---------------------------------------------------------------------------

def _q2c(aa, ab, ba, bb):
    zp = ((aa - bb) + 1j * (ab + ba)) * 0.5
    zm = ((aa + bb) + 1j * (ab - ba)) * 0.5
    return zp.astype(jnp.complex64), zm.astype(jnp.complex64)


def _c2q(zp, zm):
    aa = jnp.real(zp) + jnp.real(zm)
    bb = jnp.real(zm) - jnp.real(zp)
    ab = jnp.imag(zp) + jnp.imag(zm)
    ba = jnp.imag(zp) - jnp.imag(zm)
    return aa, ab, ba, bb


# ---------------------------------------------------------------------------
# Public transform
# ---------------------------------------------------------------------------

_TREES = ((0, 0), (0, 1), (1, 0), (1, 1))  # (row_tree, col_tree); 0=a, 1=b


@dataclass
class Pyramid:
    """dtcwt-compatible container: real lowpass + per-level complex highpasses."""

    lowpass: jnp.ndarray  # [..., 2h, 2w] interleaved tree lowpasses
    highpasses: tuple  # tuple over levels of [..., h, w, 6] complex64


def _pad_even(x):
    """Replicate-pad the trailing two axes to even sizes; returns (x, (H, W))."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2:
        x = jnp.concatenate([x, x[..., -1:, :]], axis=-2)
    if w % 2:
        x = jnp.concatenate([x, x[..., :, -1:]], axis=-1)
    return x, (h, w)


def _qshift_banks(rt, ct):
    """(h0 row, h1 row, h0 col, h1 col) q-shift analysis filters of a tree."""
    h0r, h1r = (C.QSHIFT_H0A, C.QSHIFT_H1A) if rt == 0 else (C.QSHIFT_H0B, C.QSHIFT_H1B)
    h0c, h1c = (C.QSHIFT_H0A, C.QSHIFT_H1A) if ct == 0 else (C.QSHIFT_H0B, C.QSHIFT_H1B)
    return h0r, h1r, h0c, h1c


def _qshift_synth(rt, ct):
    """(g0 row, g1 row, g0 col, g1 col, row roll, col roll) of a tree."""
    g0r, g1r = (C.QSHIFT_G0A, C.QSHIFT_G1A) if rt == 0 else (C.QSHIFT_G0B, C.QSHIFT_G1B)
    g0c, g1c = (C.QSHIFT_G0A, C.QSHIFT_G1A) if ct == 0 else (C.QSHIFT_G0B, C.QSHIFT_G1B)
    rr = C.QSHIFT_ROLL_A if rt == 0 else C.QSHIFT_ROLL_B
    rc = C.QSHIFT_ROLL_A if ct == 0 else C.QSHIFT_ROLL_B
    return g0r, g1r, g0c, g1c, rr, rc


class Transform2d:
    """Drop-in for dtcwt.Transform2d (forward/inverse), batched over leading axes.

    The transform is carried in a packed tree-domain plane layout
    [..., 16, h, w] = [ll*4, lh*4, hl*4, hh*4] (trees (rt, ct) row-major);
    ``forward``/``inverse`` add the q2c/c2q combines and the lowpass
    interleave of the dtcwt package's Pyramid on top of it."""

    @staticmethod
    def _pack_planes(ll, subs):
        """(ll dict, subs dict) -> [..., 16, h, w] in packed plane order."""
        return jnp.stack(
            [ll[tc] for tc in _TREES]
            + [subs[tc][band] for band in range(3) for tc in _TREES],
            axis=-3,
        )

    @staticmethod
    def _unpack_planes(planes):
        """[..., 16, h, w] packed planes -> (ll dict, subs dict) in _TREES order."""
        ll = {}
        subs = {}
        for ci, tc in enumerate(_TREES):
            ll[tc] = planes[..., 0 * 4 + ci, :, :]
            subs[tc] = tuple(planes[..., band * 4 + ci, :, :] for band in (1, 2, 3))
        return ll, subs

    def forward(self, x, nlevels: int = 3) -> Pyramid:
        x = jnp.asarray(x, jnp.float32)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[None]
        planes_list, sizes = self.forward_raw(x, nlevels)
        highs = [q2c_planes(p) for p in planes_list]
        # Interleave the 4 tree lowpasses: row tree -> row phase, col tree -> col phase.
        ll4 = planes_list[-1][..., :4, :, :]
        h2, w2 = ll4.shape[-2:]
        low = jnp.zeros((*ll4.shape[:-3], 2 * h2, 2 * w2), jnp.float32)
        for ci, (rt, ct) in enumerate(_TREES):
            low = low.at[..., rt::2, ct::2].set(ll4[..., ci, :, :])
        pyr = Pyramid(lowpass=low[0] if squeeze else low,
                      highpasses=tuple(h[0] if squeeze else h for h in highs))
        pyr._sizes = sizes  # original (pre-pad) sizes per level, for inverse
        return pyr

    def inverse(self, pyr: Pyramid) -> jnp.ndarray:
        highs = pyr.highpasses
        low = jnp.asarray(pyr.lowpass, jnp.float32)
        squeeze = low.ndim == 2
        if squeeze:
            low = low[None]
            highs = tuple(h[None] for h in highs)
        # Split interleaved lowpass back into per-tree arrays.
        ll4 = jnp.stack([low[..., rt::2, ct::2] for rt, ct in _TREES], axis=-3)
        planes_list = [c2q_subs(h) for h in highs]
        planes_list[-1] = jnp.concatenate([ll4, planes_list[-1]], axis=-3)
        out = self.inverse_raw(planes_list, getattr(pyr, "_sizes", None))
        return out[0] if squeeze else out

    # -- raw tree-domain interface --------------------------------------------
    # The q2c combine is a fixed unitary map; consumers that only touch a few
    # levels (the watermark codecs modify level 3 and read level-2
    # magnitudes) stay in the packed-plane layout and convert just the
    # planes they do complex math on: the q2c/c2q combines and the lowpass
    # interleave are glue the codecs never need.

    def forward_raw(self, x, nlevels: int = 3):
        """[..., H, W] -> (planes_list, sizes): planes_list[lev] is
        [..., 16, h, w] pre-q2c tree-domain planes; [..., :4, :, :] are the
        4 tree lowpasses that fed level lev+1 (deepest level's are the
        final lowpasses, NOT interleaved)."""
        planes, orig = self.analysis_level1(x)
        planes_out = [planes]
        sizes = [orig]
        for lev in range(1, nlevels):
            planes, lvl_sizes = self.analysis_qshift(planes[..., :4, :, :])
            sizes.append(lvl_sizes)
            planes_out.append(planes)
        return planes_out, sizes

    def inverse_raw(self, planes_list, sizes=None):
        """Inverse of forward_raw: reconstruct [..., H, W] from per-level raw
        planes.  Only the deepest level's ll planes are read (shallower
        levels may carry 16 planes or just the 12 highpass ones); level 0
        uses the LeGall bank, deeper levels the q-shift bank."""
        nlevels = len(planes_list)
        ll4 = planes_list[-1][..., :4, :, :]
        for lev in range(nlevels - 1, 0, -1):
            out = self.synthesis_qshift(
                jnp.concatenate([ll4, planes_list[lev][..., -12:, :, :]], axis=-3))
            if sizes is not None:
                oh, ow = sizes[lev]
                out = out[..., :oh, :ow]
            ll4 = out
        out = self.synthesis_legall(
            jnp.concatenate([ll4, planes_list[0][..., -12:, :, :]], axis=-3))
        if sizes is not None:
            oh, ow = sizes[0]
            out = out[..., :oh, :ow]
        return out

    # -- single-level building blocks (codec hot path) ------------------------

    def analysis_level1(self, x, lowpass_only: bool = False):
        """[..., H, W] -> (planes, orig_size): [..., 16, h, w] raw planes, or
        [..., 4, h, w] lowpasses when ``lowpass_only`` (the mask channel
        never reads its level-1 subbands).  Tree = sampling phase."""
        x = jnp.asarray(x, jnp.float32)
        x, orig = _pad_even(x)
        ll = {}
        subs = {}
        for rt, ct in _TREES:
            if lowpass_only:
                lo = _along_rows(down2, x, C.LEGALL_H0, rt)
                ll[(rt, ct)] = down2(lo, C.LEGALL_H0, ct)
                continue
            l, lh, hl, hh = _analysis2d(x, C.LEGALL_H0, C.LEGALL_H1, rt, ct)
            ll[(rt, ct)] = l
            subs[(rt, ct)] = (lh, hl, hh)
        if lowpass_only:
            return jnp.stack([ll[tc] for tc in _TREES], axis=-3), orig
        return self._pack_planes(ll, subs), orig

    def analysis_qshift(self, ll4, lowpass_only: bool = False):
        """[..., 4, h, w] tree lowpasses -> (planes, pre_pad_size): one
        q-shift analysis level, [..., 16 or 4, h/2, w/2]."""
        stack, lvl_sizes = _pad_even(jnp.asarray(ll4, jnp.float32))
        ll = {}
        subs = {}
        for ci, (rt, ct) in enumerate(_TREES):
            xi = stack[..., ci, :, :]
            h0r, h1r, h0c, h1c = _qshift_banks(rt, ct)
            lo = _along_rows(down2, xi, h0r, 0)
            ll[(rt, ct)] = down2(lo, h0c, 0)
            if not lowpass_only:
                hi = _along_rows(down2, xi, h1r, 0)
                subs[(rt, ct)] = (down2(lo, h1c, 0), down2(hi, h0c, 0),
                                  down2(hi, h1c, 0))
        if lowpass_only:
            return jnp.stack([ll[tc] for tc in _TREES], axis=-3), lvl_sizes
        return self._pack_planes(ll, subs), lvl_sizes

    def analysis_qshift_hp(self, ll4):
        """Highpass-only q-shift level: [..., 4, h, w] tree lowpasses ->
        ([..., 12, h/2, w/2] planes [lh*4, hl*4, hh*4], pre_pad_size),
        for consumers that never read the next ll band (the codec mask and
        level-3 coefficient paths).  The ll column filters are dead code
        that XLA drops."""
        planes, lvl_sizes = self.analysis_qshift(ll4)
        return planes[..., 4:, :, :], lvl_sizes

    def synthesis_qshift(self, planes16):
        """[..., 16, h, w] raw planes -> [..., 4, 2h, 2w] tree lowpasses of
        the level below (one q-shift synthesis level, before cropping)."""
        ll, subs = self._unpack_planes(planes16)
        outs = []
        for rt, ct in _TREES:
            lh, hl, hh = subs[(rt, ct)]
            g0r, g1r, g0c, g1c, rr, rc = _qshift_synth(rt, ct)
            lo = up2(ll[(rt, ct)], g0c, 0) + up2(lh, g1c, 0)
            hi = up2(hl, g0c, 0) + up2(hh, g1c, 0)
            lo = jnp.roll(lo, rc, axis=-1)
            hi = jnp.roll(hi, rc, axis=-1)
            xx = _along_rows(up2, lo, g0r, 0) + _along_rows(up2, hi, g1r, 0)
            outs.append(jnp.roll(xx, rr, axis=-2))
        return jnp.stack(outs, axis=-3)

    def synthesis_qshift_ll(self, ll4):
        """Lowpass-only q-shift synthesis: [..., 4, h, w] tree lowpasses
        (all highpasses zero, e.g. a delta pyramid above the modified level)
        -> [..., 4, 2h, 2w].  1/4 the work of synthesis_qshift."""
        outs = []
        for ci, (rt, ct) in enumerate(_TREES):
            g0r, _, g0c, _, rr, rc = _qshift_synth(rt, ct)
            lo = jnp.roll(up2(ll4[..., ci, :, :], g0c, 0), rc, axis=-1)
            outs.append(jnp.roll(_along_rows(up2, lo, g0r, 0), rr, axis=-2))
        return jnp.stack(outs, axis=-3)

    def synthesis_legall(self, planes16):
        """[..., 16, h, w] raw planes -> [..., 2h, 2w]: the LeGall level-1
        synthesis, averaged over the 4 trees (before cropping)."""
        ll, subs = self._unpack_planes(planes16)
        out = 0.0
        for rt, ct in _TREES:
            lh, hl, hh = subs[(rt, ct)]
            out = out + _synthesis2d(
                ll[(rt, ct)], lh, hl, hh, C.LEGALL_G0, C.LEGALL_G1,
                rt, ct, C.LEGALL_ROLL, C.LEGALL_ROLL,
            )
        return out * 0.25

    def synthesis_legall_hp(self, subs12):
        """Highpass-only LeGall level-1 synthesis: [..., 12, h, w] planes
        [lh*4, hl*4, hh*4] with an implicit ZERO lowpass -> [..., 2h, 2w]
        (the codec decode's 1-level inverse)."""
        zero_ll = jnp.zeros((*subs12.shape[:-3], 4, *subs12.shape[-2:]), subs12.dtype)
        return self.synthesis_legall(jnp.concatenate([zero_ll, subs12], axis=-3))

    def synthesis_legall_ll(self, ll4):
        """Lowpass-only LeGall level-1 synthesis: [..., 4, h, w] tree
        lowpasses -> [..., 2h, 2w] (4-tree average)."""
        out = 0.0
        for ci, (rt, ct) in enumerate(_TREES):
            li = ll4[..., ci, :, :]
            z = jnp.zeros_like(li)
            out = out + _synthesis2d(li, z, z, z, C.LEGALL_G0, C.LEGALL_G1,
                                     rt, ct, C.LEGALL_ROLL, C.LEGALL_ROLL)
        return out * 0.25


def q2c_planes(planes):
    """Raw [..., 16, h, w] (or highpass-only [..., 12, h, w]) -> complex
    subbands [..., h, w, 6] (band order [LH+, LH-, HL+, HL-, HH+, HH-],
    matching Pyramid)."""
    off = planes.shape[-3] - 12  # 4 for full planes, 0 for hp-only
    vals = []
    for band in range(3):
        aa = planes[..., off + band * 4 + 0, :, :]
        ab = planes[..., off + band * 4 + 1, :, :]
        ba = planes[..., off + band * 4 + 2, :, :]
        bb = planes[..., off + band * 4 + 3, :, :]
        zp, zm = _q2c(aa, ab, ba, bb)
        vals += [zp, zm]
    return jnp.stack(vals, axis=-1)


def q2c_magnitudes(planes):
    """Raw [..., 16, h, w] (or highpass-only [..., 12, h, w]) -> |subband|
    [..., 6, h, w] without materializing complex intermediates
    (|zp| = 0.5 sqrt((aa-bb)^2 + (ab+ba)^2))."""
    off = planes.shape[-3] - 12
    out = []
    for band in range(3):
        aa = planes[..., off + band * 4 + 0, :, :]
        ab = planes[..., off + band * 4 + 1, :, :]
        ba = planes[..., off + band * 4 + 2, :, :]
        bb = planes[..., off + band * 4 + 3, :, :]
        out.append(0.5 * jnp.sqrt((aa - bb) ** 2 + (ab + ba) ** 2))
        out.append(0.5 * jnp.sqrt((aa + bb) ** 2 + (ab - ba) ** 2))
    return jnp.stack(out, axis=-3)


def c2q_subs(high6):
    """Complex subbands [..., h, w, 6] -> raw sub planes [..., 12, h, w]
    (the inverse of q2c_planes; ll planes are NOT included)."""
    outs = []
    for i in range(3):
        aa, ab, ba, bb = _c2q(high6[..., 2 * i], high6[..., 2 * i + 1])
        outs += [aa, ab, ba, bb]
    return jnp.stack(outs, axis=-3)
