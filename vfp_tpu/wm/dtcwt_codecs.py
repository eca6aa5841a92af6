"""DT-CWT watermark codecs (key/spread-spectrum and image variants).

Reference algorithms (reference: src/offmark/embed/dtcwt_key_encoder.py,
dtcwt_img_encoder.py, extract/dtcwt_key_decoder.py, dtcwt_img_decoder.py):
3-level DT-CWT of the U and Y channels; 6 per-subband perceptual masks from
the 2x2-mean-filtered |level-2 Y highpasses|, rebinned to the level-3 grid
and quantized by ``step``; the watermark's level-1 DT-CWT highpasses are
replicated into the 4 corners of each level-3 subband and added scaled by
``alpha * mask``.  Decoding divides the marked level-3 U highpasses by
``mask * alpha``, folds the 4 corner replicas, and inverts a 1-level pyramid
with a zero lowpass.

The DT-CWT itself is this framework's own (ops/dtcwt.py — see its module
docstring for documented deviations from the ``dtcwt`` package); all codec
math on top mirrors the reference formulas, batched over frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.color import bgr_to_yuv, yuv_to_bgr, M_BWD
from ..ops.dtcwt import (Pyramid, Transform2d, c2q_subs, q2c_magnitudes,
                         q2c_planes)
from ..ops.filters import filter2d_mean2x2, rebin_mean


def infer_wm_shape(img_shape):
    """Watermark plane dims for a frame (reference: dtcwt_key_encoder.py:46-53)."""
    h = (((img_shape[0] + 1) // 2 + 1) // 2 + 1) // 2
    w = (((img_shape[1] + 1) // 2 + 1) // 2 + 1) // 2
    return (h + h % 2, w + w % 2)


def _corner_replicate(coeff: jnp.ndarray, shape) -> jnp.ndarray:
    """Place [..., h, w] coeffs into the 4 corners of a [..., H, W] zero plane
    (reference: dtcwt_key_encoder.py:36-42); overlaps add like the
    sequential corner writes? No — the reference *assigns*, so later corners
    overwrite earlier ones where they overlap.  Replicated here with
    assignment order [:h,:w], [-h:,:w], [:h,-w:], [-h:,-w:]."""
    h, w = coeff.shape[-2], coeff.shape[-1]
    out = jnp.zeros((*coeff.shape[:-2], *shape), coeff.dtype)
    out = out.at[..., :h, :w].set(coeff)
    out = out.at[..., -h:, :w].set(coeff)
    out = out.at[..., :h, -w:].set(coeff)
    out = out.at[..., -h:, -w:].set(coeff)
    return out


def _fold_corners(coeff: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Sum the 4 corner [h, w] windows (reference: dtcwt_key_decoder.py:31-33)."""
    return (
        coeff[..., :h, :w]
        + coeff[..., :h, -w:]
        + coeff[..., -h:, :w]
        + coeff[..., -h:, -w:]
    )


# watermark-spectrum device constants, keyed by plane bytes (wm_hp_device)
_WM_HP_CACHE: dict = {}
# object-identity front cache: (hw, id(wm)) -> (wm ref, spectrum).
# Holding the wm reference keeps the id() valid; the hit avoids materializing
# np.asarray(wm) — for a device-resident wm that is a full-plane device->host
# transfer per call.
_WM_ID_CACHE: dict = {}


@dataclass(frozen=True)
class _DtcwtBase:
    alpha: float = 10.0
    step: float = 5.0
    nlevels: int = 3
    normalize_masks: bool = False  # True for the img variant

    def wm_capacity(self, frame_shape):
        return infer_wm_shape(frame_shape)

    def _t(self) -> Transform2d:
        return Transform2d()

    # -- watermark spectrum -------------------------------------------------
    def wm_highpass(self, wm: jnp.ndarray) -> jnp.ndarray:
        """Level-1 DT-CWT highpasses of the watermark plane [h, w] -> [h/2, w/2, 6]
        (reference: dtcwt_key_encoder.py:12-15)."""
        t = self._t()
        return t.forward(jnp.asarray(wm, jnp.float32), nlevels=1).highpasses[0]

    def _joint_forward(self, y: jnp.ndarray, u: jnp.ndarray):
        """One batched DT-CWT over [Y; U] (halves transform launches), split
        back into (y_hp2, u_pyramid)."""
        b = y.shape[0]
        t = self._t()
        both = t.forward(jnp.concatenate([y, u], axis=0), nlevels=self.nlevels)
        uc = Pyramid(lowpass=both.lowpass[b:],
                     highpasses=tuple(h[b:] for h in both.highpasses))
        uc._sizes = both._sizes
        return both.highpasses[1][:b], uc

    def _joint_forward_raw(self, y: jnp.ndarray, u: jnp.ndarray):
        """One batched raw-domain DT-CWT over [Y; U]: the codecs only do
        complex math on the (tiny) level-3 grid, so everything stays in the
        packed tree-plane layout — no q2c/c2q or lowpass interleave glue on
        the frame-scale levels."""
        t = self._t()
        planes, sizes = t.forward_raw(
            jnp.concatenate([y, u], axis=0), nlevels=self.nlevels)
        return t, planes, sizes

    def _masks3(self, y: jnp.ndarray, shape3) -> jnp.ndarray:
        """[B, H, W] Y channel -> [B, h3, w3, 6] per-subband masks
        (reference: dtcwt_key_encoder.py:29-33, dtcwt_img_encoder.py:31-35)."""
        t = self._t()
        yc = t.forward(y, nlevels=self.nlevels)
        return self._masks3_from_hp2(yc.highpasses[1], shape3)

    def _masks3_from_hp2(self, hp2c: jnp.ndarray, shape3, zero_guard: bool = False) -> jnp.ndarray:
        hp2 = jnp.abs(hp2c)  # [B, h2, w2, 6]
        hp2 = jnp.moveaxis(hp2, -1, 1)  # [B, 6, h2, w2]
        return self._masks3_from_mags(hp2, shape3, zero_guard)

    def _masks3_from_mags(self, hp2, shape3, zero_guard: bool = False) -> jnp.ndarray:
        """[B, 6, h2, w2] subband magnitudes -> [B, h3, w3, 6] masks."""
        m = filter2d_mean2x2(hp2)
        m = rebin_mean(m, shape3)
        m = jnp.ceil(m / self.step)
        if zero_guard:
            # decoder-side ==0 -> 0.01 replacement; must run BEFORE the
            # max(12, amax) normalization so flat-luminance coefficients keep
            # the reference's weighting (reference: dtcwt_img_decoder.py:25-26)
            m = jnp.where(m == 0, 0.01, m)
        if self.normalize_masks:
            mx = jnp.max(m, axis=(-2, -1), keepdims=True)
            m = m / jnp.maximum(12.0, mx)
        return jnp.moveaxis(m, 1, -1)  # [B, h3, w3, 6]

    # -- raw-domain embed/decode (the hot path) ---------------------------
    def _embed_channel_raw(self, y: jnp.ndarray, u: jnp.ndarray,
                           wm_hp: jnp.ndarray) -> jnp.ndarray:
        """Same math as _embed_channel in the raw tree domain, via DELTA
        synthesis: the embed delta alpha*mask*wm is independent of the U
        coefficients, and the transform is linear, so

          marked = inverse(forward(u) + delta_pyr) = u + inverse(delta_pyr)

        (exactly, minus the forward/inverse PR error ~2e-7 the full path
        carried).  U is never analyzed at all; the delta pyramid is zero
        everywhere except the level-3 highpasses, so levels 2/1 synthesize
        lowpass-only (4 of 16 planes).  Y runs lowpass-only at level 1 and
        a full level 2 for the masks; level 3 exists only as grid geometry."""
        if self.nlevels != 3:
            return self._embed_channel_raw_generic(y, u, wm_hp)
        t = self._t()
        y_ll1, s0 = t.analysis_level1(y, lowpass_only=True)
        return u + self._embed_delta_from_ll1(y_ll1, wm_hp, s0)

    def _embed_delta_from_ll1(self, y_ll1: jnp.ndarray, wm_hp: jnp.ndarray,
                              s0) -> jnp.ndarray:
        """Y tree lowpasses [B, 4, h1, w1] -> pixel-space U delta [B, H, W]
        (cropped to ``s0``).  The Y level-2 analysis runs highpass-only:
        the mask path never reads its ll band."""
        t = self._t()
        y_hp2, s1 = t.analysis_qshift_hp(y_ll1)
        h2, w2 = y_hp2.shape[-2], y_hp2.shape[-1]
        # level-3 grid geometry (_pad_even rules), without running level 3
        shape3 = ((h2 + 1) // 2, (w2 + 1) // 2)
        masks = self._masks3_from_mags(q2c_magnitudes(y_hp2), shape3)
        wm_plane = _corner_replicate(jnp.moveaxis(wm_hp, -1, 0), shape3)
        wm_plane = jnp.moveaxis(wm_plane, 0, -1)[None]  # [1, h3, w3, 6]
        delta6 = self.alpha * masks.astype(wm_plane.dtype) * wm_plane
        dsubs = c2q_subs(delta6)  # [B, 12, h3, w3]
        d3 = jnp.concatenate(
            [jnp.zeros(dsubs.shape[:-3] + (4,) + dsubs.shape[-2:], dsubs.dtype),
             dsubs], axis=-3)
        dll2 = t.synthesis_qshift(d3)[..., :h2, :w2]
        dll1 = t.synthesis_qshift_ll(dll2)[..., : s1[0], : s1[1]]
        return t.synthesis_legall_ll(dll1)[..., : s0[0], : s0[1]]

    def _decode_channel_raw(self, y: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """Decode needs only: Y level-2 subbands (masks) and U level-3
        subbands (coefficients) — every other analysis level runs
        lowpass-only."""
        if self.nlevels != 3:
            return self._decode_channel_raw_generic(y, u)
        b = y.shape[0]
        t = self._t()
        ll1, _ = t.analysis_level1(jnp.concatenate([y, u], axis=0),
                                   lowpass_only=True)
        return self._decode_from_ll1(ll1[:b], ll1[b:])

    def _decode_from_ll1(self, y_ll1: jnp.ndarray, u_ll1: jnp.ndarray) -> jnp.ndarray:
        t = self._t()
        u_ll2, _ = t.analysis_qshift(u_ll1, lowpass_only=True)
        u_hp3, _ = t.analysis_qshift_hp(u_ll2)  # only the subband coeffs used
        shape3 = (u_hp3.shape[-2], u_hp3.shape[-1])
        y_hp2, _ = t.analysis_qshift_hp(y_ll1)  # masks never read the ll band
        masks = self._masks3_from_mags(q2c_magnitudes(y_hp2), shape3,
                                       zero_guard=True)
        coeff = q2c_planes(u_hp3) / masks.astype(jnp.complex64) / self.alpha
        hh, ww = (shape3[0] + 1) // 2, (shape3[1] + 1) // 2
        folded = _fold_corners(jnp.moveaxis(coeff, -1, 1), hh, ww)
        folded = jnp.moveaxis(folded, 1, -1)  # [B, hh, ww, 6]
        return t.synthesis_legall_hp(c2q_subs(folded))

    def _embed_channel_raw_generic(self, y, u, wm_hp):
        """nlevels != 3 fallback: full joint raw pyramid, no level skipping."""
        b = y.shape[0]
        t, planes, sizes = self._joint_forward_raw(y, u)
        h3 = planes[self.nlevels - 1]
        shape3 = (h3.shape[-2], h3.shape[-1])
        masks = self._masks3_from_mags(q2c_magnitudes(planes[1][:b]), shape3)
        wm_plane = _corner_replicate(jnp.moveaxis(wm_hp, -1, 0), shape3)
        wm_plane = jnp.moveaxis(wm_plane, 0, -1)[None]
        delta6 = self.alpha * masks.astype(wm_plane.dtype) * wm_plane
        dsubs = c2q_subs(delta6)
        u_planes = [p[b:] for p in planes]
        u_planes[self.nlevels - 1] = jnp.concatenate(
            [h3[b:, :4], h3[b:, 4:] + dsubs], axis=-3)
        return t.inverse_raw(u_planes, sizes)

    def _decode_channel_raw_generic(self, y, u):
        b = y.shape[0]
        t, planes, sizes = self._joint_forward_raw(y, u)
        h3 = planes[self.nlevels - 1]
        shape3 = (h3.shape[-2], h3.shape[-1])
        masks = self._masks3_from_mags(q2c_magnitudes(planes[1][:b]), shape3,
                                       zero_guard=True)
        coeff = q2c_planes(h3[b:]) / masks.astype(jnp.complex64) / self.alpha
        hh, ww = (shape3[0] + 1) // 2, (shape3[1] + 1) // 2
        folded = _fold_corners(jnp.moveaxis(coeff, -1, 1), hh, ww)
        folded = jnp.moveaxis(folded, 1, -1)
        return t.synthesis_legall_hp(c2q_subs(folded))

    # -- channel-level embed/decode ------------------------------------------
    def _embed_channel(self, y: jnp.ndarray, u: jnp.ndarray, wm_hp: jnp.ndarray) -> jnp.ndarray:
        t = self._t()
        y_hp2, uc = self._joint_forward(y, u)
        h3 = uc.highpasses[self.nlevels - 1]
        masks = self._masks3_from_hp2(y_hp2, (h3.shape[-3], h3.shape[-2]))
        wm_plane = _corner_replicate(
            jnp.moveaxis(wm_hp, -1, 0), (h3.shape[-3], h3.shape[-2])
        )  # [6, h3, w3]
        wm_plane = jnp.moveaxis(wm_plane, 0, -1)[None]  # [1, h3, w3, 6]
        new_h3 = h3 + self.alpha * masks.astype(h3.dtype) * wm_plane
        highs = tuple(
            new_h3 if lev == self.nlevels - 1 else uc.highpasses[lev]
            for lev in range(self.nlevels)
        )
        pyr = Pyramid(lowpass=uc.lowpass, highpasses=highs)
        pyr._sizes = uc._sizes
        return t.inverse(pyr)

    def _decode_channel(self, y: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        t = self._t()
        y_hp2, uc = self._joint_forward(y, u)
        h3 = uc.highpasses[self.nlevels - 1]
        masks = self._masks3_from_hp2(y_hp2, (h3.shape[-3], h3.shape[-2]),
                                      zero_guard=True)
        coeff = h3 / masks.astype(h3.dtype) / self.alpha
        hh, ww = (h3.shape[-3] + 1) // 2, (h3.shape[-2] + 1) // 2
        folded = _fold_corners(jnp.moveaxis(coeff, -1, 1), hh, ww)  # [B, 6, hh, ww]
        folded = jnp.moveaxis(folded, 1, -1)  # [B, hh, ww, 6]
        low = jnp.zeros((u.shape[0], hh * 2, ww * 2), jnp.float32)
        return t.inverse(Pyramid(lowpass=low, highpasses=(folded,)))

    # -- uint8 frame API -------------------------------------------------------
    # The frame APIs are whole-function jitted and hand the watermark
    # spectrum across calls as a real (re, im) stack, so the _q2c/_c2q
    # complex intermediates stay inside one compiled graph.
    def mark_frames(self, frames: jnp.ndarray, wm: jnp.ndarray) -> jnp.ndarray:
        """[B, H, W, 3] uint8 + watermark plane [h, w] -> marked uint8.

        Accepts the plane flattened too (pipeline drivers pass 1-D): the
        plane dims are a pure function of the frame shape.

        Eager calls hoist the watermark's level-1 spectrum to a cached
        device constant (wm is fixed across a segment; recomputing it per
        batch was 16% of the 1080p mark wall — r4 stage profile) and run
        the jitted ``mark_frames_hp``.  Under an outer trace (jit/vmap/
        shard_map pass tracers) everything stays in-graph as before.
        """
        if isinstance(frames, jax.core.Tracer) or isinstance(wm, jax.core.Tracer):
            return self._mark_frames_traced(frames, wm)
        return self.mark_frames_hp(frames, self.wm_hp_device(frames.shape[1:3], wm))

    def wm_hp_device(self, hw, wm) -> jnp.ndarray:
        """Cached device-resident (real, imag) f32 stack [2, h1, w1, 6] of
        the watermark plane's level-1 spectrum.  Computed under jit (complex
        stays internal) once per distinct plane; passing the cached device
        array as an argument costs no transfer."""
        import numpy as np

        idk = (hw, id(wm))
        id_hit = _WM_ID_CACHE.get(idk)
        if id_hit is not None and id_hit[0] is wm:
            return id_hit[1]
        arr = np.asarray(wm, np.float32)
        ck = (hw, arr.shape, hash(arr.tobytes()))
        hit = _WM_HP_CACHE.get(ck)
        if hit is None:
            cap = self.wm_capacity((hw[0], hw[1], 3))

            @jax.jit
            def _ri(w):
                hp = self.wm_highpass(w.reshape(cap))
                return jnp.stack([hp.real, hp.imag])

            hit = _ri(arr)
            if len(_WM_HP_CACHE) > 8:
                _WM_HP_CACHE.clear()
            _WM_HP_CACHE[ck] = hit
        if len(_WM_ID_CACHE) > 8:
            _WM_ID_CACHE.clear()
        _WM_ID_CACHE[idk] = (wm, hit)
        return hit

    @partial(jax.jit, static_argnums=0)
    def mark_frames_hp(self, frames: jnp.ndarray,
                       wm_hp_ri: jnp.ndarray) -> jnp.ndarray:
        """mark_frames with the watermark spectrum precomputed
        (``wm_hp_ri`` = stacked real/imag planes from wm_hp_device)."""
        return self._mark_impl(
            jnp.asarray(frames), jax.lax.complex(wm_hp_ri[0], wm_hp_ri[1]))

    def _mark_frames_traced(self, frames, wm):
        frames = jnp.asarray(frames)
        wm_hp = self.wm_highpass(
            jnp.asarray(wm).reshape(self.wm_capacity(frames.shape[1:]))
        )
        return self._mark_impl(frames, wm_hp)

    def _mark_impl(self, frames: jnp.ndarray, wm_hp: jnp.ndarray) -> jnp.ndarray:
        """Shared mark body.  The output adds only the U-channel delta back
        onto the ORIGINAL pixels (marked = x + du * M_BWD[:, 1]): for
        integer inputs the reference's float color roundtrip is the
        identity after rounding, so reconstructing via
        yuv_to_bgr(bgr_to_yuv(x)) is pure glue."""
        f32 = frames.astype(jnp.float32)
        yuv = bgr_to_yuv(f32)
        u = yuv[..., 1]
        u_new = self._embed_channel_raw(yuv[..., 0], u, wm_hp)
        marked = f32 + (u_new - u)[..., None] * jnp.asarray(M_BWD[:, 1])
        return jnp.round(jnp.clip(marked, 0.0, 255.0)).astype(jnp.uint8)

    @partial(jax.jit, static_argnums=0)
    def extract_frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        """[B, H, W, 3] uint8 -> recovered watermark planes [B, h, w]."""
        frames = jnp.asarray(frames)
        yuv = bgr_to_yuv(frames.astype(jnp.float32))
        return self._decode_channel_raw(yuv[..., 0], yuv[..., 1])


@dataclass(frozen=True)
class DtcwtKey(_DtcwtBase):
    """Keyed spread-spectrum variant (reference default_scale=10,
    dtcwt_key_encoder.py:7-10); pairs with CorrShuffler/DeCorrShuffler."""

    alpha: float = 10.0


@dataclass(frozen=True)
class DtcwtImg(_DtcwtBase):
    """Visible-image variant (reference default_scale=1.5 + mask
    normalization, dtcwt_img_encoder.py:9,34); pairs with BlockShuffler."""

    alpha: float = 1.5
    normalize_masks: bool = True
