"""DWT+DCT+SVD QIM watermark codec, batched over frames.

The reference's primary algorithm (used by every HLS/leak workflow):
per channel with a positive scale (default only U), 1-level Haar DWT of the
frame cropped to a multiple of 4, then for every 4x4 block of the LL band
``s0' = (s0 // scale + 0.25 + 0.5 * bit) * scale`` on the dominant singular
value of the block's DCT, reconstruct, inverse DWT (reference:
src/offmark/embed/dwt_dct_svd_encoder.py:19-45).  Extraction reads
``bit = (s0 % scale) > scale / 2`` (reference:
src/offmark/extract/dwt_dct_svd_decoder.py:12-37).

Batched redesign: the frame loop and the ~32k-per-frame block loop become a
single jitted program over ``[B, H, W, C]`` — Haar as strided butterflies,
the per-block SVD as a batched dominant-triplet power iteration, and the s0
rewrite as a rank-1 update.  No Python control flow depends on data;
everything vmaps/shards over the batch axis.

The reference's per-block DCT is **provably a no-op for this codec** and is
omitted on every path: cv2.dct is the orthonormal DCT-II, so M = D B Dᵀ with
D orthogonal, and if B = U S Vᵀ then M = (D U) S (D V)ᵀ — same singular
values.  Embedding modifies S and inverts: idct(D U S' (D V)ᵀ) = U S' Vᵀ,
i.e. exactly the rank-1 s0 update applied to the raw LL block; extraction
reads only s0.  (reference: src/offmark/embed/dwt_dct_svd_encoder.py:42-45
computes cv2.dct -> np.linalg.svd -> cv2.idct per block; the transform pair
cancels identically.)  Payloads interoperate unchanged in both directions —
embedded s0 values sit at QIM bin centers, far from the decision edges this
float-level difference could move.

Parity quirks reproduced on purpose:
  * capacity is ``H*W // 64`` (reference: dwt_dct_svd_encoder.py:14-17) even
    though only ``(H//4*4 /2 //4) * (W//4*4 /2 //4)`` blocks exist; extra
    watermark entries are ignored on embed and decoded as 0 (the reference
    decoder returns a zero-initialized array of capacity length,
    dwt_dct_svd_decoder.py:14-21).
  * the DWT runs on the ``[:H//4*4, :W//4*4]`` crop; remaining rows/cols pass
    through untouched.
  * LL blocks beyond the 4-aligned region of the (H//4*4)/2-sized band are
    transformed by the DWT round-trip but not modified (exact identity here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax.numpy as jnp

from ..ops.color import bgr_to_yuv, yuv_to_bgr
from ..ops.haar import haar_dwt2, haar_idwt2
from ..ops.soa import (
    image_to_soa,
    rank1_update_soa,
    soa_to_image,
    top_triplet_soa,
)


def block_grid(frame_shape, blk: int = 4):
    """((nbh, nbw), capacity): actual LL block grid and declared capacity."""
    h, w = frame_shape[0], frame_shape[1]
    h4, w4 = h // 4 * 4, w // 4 * 4
    nbh, nbw = (h4 // 2) // blk, (w4 // 2) // blk
    return (nbh, nbw), h * w // 64


@dataclass(frozen=True)
class DwtDctSvd:
    """Functional codec; instances are static (hashable) so methods jit cleanly."""

    scales: Sequence[float] = (0.0, 15.0, 0.0)
    blk: int = 4

    # -- reference-compatible capacity -------------------------------------
    def wm_capacity(self, frame_shape):
        return (1, frame_shape[0] * frame_shape[1] // 64)

    # -- core per-channel ops (batched [B, H, W], SoA hot path) -------------
    def _embed_channel(self, chan: jnp.ndarray, wm_bits: jnp.ndarray, scale: float):
        b, h, w = chan.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        (nbh, nbw), _ = block_grid((h, w), self.blk)
        ll, lh, hl, hh = haar_dwt2(chan[:, :h4, :w4])
        region = ll[:, : nbh * self.blk, : nbw * self.blk]
        m = image_to_soa(region, self.blk)  # [B, 16, N] spatial
        bits = wm_bits[: nbh * nbw].astype(jnp.float32)
        # no DCT: orthogonal similarity preserves the triplet (see module
        # docstring) — the rank-1 update applies to the raw LL blocks
        s0, u, v = top_triplet_soa(m)
        s_new = (jnp.floor(s0 / scale) + 0.25 + 0.5 * bits[None, :]) * scale
        m = rank1_update_soa(m, s_new - s0, u, v)
        region_new = soa_to_image(m, nbh * self.blk, nbw * self.blk, self.blk)
        if (nbh * self.blk, nbw * self.blk) == ll.shape[1:]:
            ll = region_new
        else:
            ll = ll.at[:, : nbh * self.blk, : nbw * self.blk].set(region_new)
        out = haar_idwt2(ll, lh, hl, hh)
        if (h4, w4) == (h, w):
            return out
        return chan.at[:, :h4, :w4].set(out)

    def _decode_channel(self, chan: jnp.ndarray, scale: float) -> jnp.ndarray:
        b, h, w = chan.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        (nbh, nbw), _ = block_grid((h, w), self.blk)
        ll, *_ = haar_dwt2(chan[:, :h4, :w4])
        m = image_to_soa(ll[:, : nbh * self.blk, : nbw * self.blk], self.blk)
        s0, _, _ = top_triplet_soa(m)  # s0(dct(B)) == s0(B): DCT omitted
        return (jnp.mod(s0, scale) > scale * 0.5).astype(jnp.float32)  # [B, N]

    # -- YUV-level API -------------------------------------------------------
    def encode_yuv(self, yuv: jnp.ndarray, wm: jnp.ndarray) -> jnp.ndarray:
        """[B, H, W, 3] float YUV + [capacity] watermark bits -> marked YUV."""
        wm_flat = wm.reshape(-1)
        out = yuv
        for c, scale in enumerate(self.scales):
            if scale <= 0:
                continue
            out = out.at[..., c].set(self._embed_channel(out[..., c], wm_flat, float(scale)))
        return out

    def decode_yuv(self, yuv: jnp.ndarray) -> jnp.ndarray:
        """[B, H, W, 3] float YUV -> [B, capacity] decoded bit plane (f32 0/1).

        Matches the reference's channel-1 output with zero padding up to
        capacity (reference: dwt_dct_svd_decoder.py:14-21).
        """
        b, h, w, _ = yuv.shape
        (nbh, nbw), capacity = block_grid((h, w), self.blk)
        bits = self._decode_channel(yuv[..., 1], float(self.scales[1]))
        pad = capacity - nbh * nbw
        return jnp.pad(bits, ((0, 0), (0, pad)))

    # -- minimal-traffic helpers ----------------------------------------------
    def _ll_from_frames(self, frames_f32: jnp.ndarray, chan: int) -> jnp.ndarray:
        """LL band of one YUV channel straight from uint8 frames in one fused
        pass: channel value from the 3x3 color row, Haar LL = 2x2 sum / 2.

        Avoids materializing the full YUV tensor and the detail bands — only
        the LL band (H*W/4 floats) ever reaches HBM.
        """
        from ..ops.color import M_FWD, OFF_FWD

        b, h, w, _ = frames_f32.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        x = jnp.moveaxis(frames_f32[:, :h4, :w4, :], -1, 1)  # planar [B, 3, h4, w4]
        c = (M_FWD[chan, 0] * x[:, 0] + M_FWD[chan, 1] * x[:, 1]
             + M_FWD[chan, 2] * x[:, 2] + OFF_FWD[chan])
        return (
            c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2]
        ) * 0.5

    def _region_triplet(self, ll: jnp.ndarray):
        """(m [B,16,N], s0, u, v) of the block-aligned LL region — the shared
        front half of every delta helper."""
        b, hc, wc = ll.shape
        nbh, nbw = hc // self.blk, wc // self.blk
        m = image_to_soa(ll[:, : nbh * self.blk, : nbw * self.blk], self.blk)
        s0, u, v = top_triplet_soa(m)  # DCT omitted (module docstring)
        return m, s0, u, v

    def _delta_image(self, ds, u, v, ll_shape):
        """ds·u·vᵀ assembled back onto the LL grid (zero outside the region)."""
        b, hc, wc = ll_shape
        nbh, nbw = hc // self.blk, wc // self.blk
        zero = jnp.zeros((b, self.blk * self.blk, nbh * nbw), jnp.float32)
        delta = soa_to_image(rank1_update_soa(zero, ds, u, v),
                             nbh * self.blk, nbw * self.blk, self.blk)
        if (nbh * self.blk, nbw * self.blk) == (hc, wc):
            return delta
        return (jnp.zeros(ll_shape, jnp.float32)
                .at[:, : nbh * self.blk, : nbw * self.blk].set(delta))

    def _ll_delta(self, ll: jnp.ndarray, wm_bits: jnp.ndarray, scale: float) -> jnp.ndarray:
        """Marked-LL minus LL over the block-aligned region, zero elsewhere.

        The delta is assembled DIRECTLY as ds·u·vᵀ (not marked-minus-input,
        which loses low bits of the small delta to cancellation against the
        large LL values)."""
        b, hc, wc = ll.shape
        nbh, nbw = hc // self.blk, wc // self.blk
        m, s0, u, v = self._region_triplet(ll)
        bits = wm_bits[: nbh * nbw].astype(jnp.float32)
        s_new = (jnp.floor(s0 / scale) + 0.25 + 0.5 * bits[None, :]) * scale
        return self._delta_image(s_new - s0, u, v, ll.shape)

    def _ll_delta2(self, ll: jnp.ndarray, scale: float) -> jnp.ndarray:
        """[2, B, hc, wc]: the LL delta under bit=0 and bit=1 for EVERY block,
        from ONE dominant-triplet solve (s0/u/v are bit-independent — only
        the QIM target differs).  Feeds the low-link two-plane transport."""
        m, s0, u, v = self._region_triplet(ll)
        base = jnp.floor(s0 / scale) + 0.25
        # identical float association to _ll_delta's s_new — (floor + 0.25)
        # + 0.5*bit — so the planes stay BIT-EXACT vs the per-variant path
        # (test_two_plane_matches_per_variant)
        return jnp.stack([
            self._delta_image((base + 0.5 * b) * scale - s0, u, v, ll.shape)
            for b in (0.0, 1.0)
        ])

    # -- uint8 frame-level API (the jittable hot path) -----------------------
    def mark_frames(self, frames: jnp.ndarray, wm: jnp.ndarray) -> jnp.ndarray:
        """[B, H, W, 3] uint8 (reference channel convention) -> marked uint8.

        Reproduces the reference frame path: float32 -> BGR2YUV -> encode ->
        YUV2BGR -> clip(0,255) -> round-half-even -> uint8 (reference:
        video/embedder.py:33-39).

        Fast path for the default single-channel embedding, exploiting two
        linearities (same math, fewer HBM passes):
        * only the LL band changes, and idwt(LL', details) = U +
          upsample2x2(LL' - LL) / 2 — the detail bands and the inverse DWT
          never need to exist;
        * YUV2BGR is affine, so the output is the color roundtrip of the
          original frame plus (delta U) * M_BWD[:, chan].
        """
        from ..ops.color import M_BWD, M_FWD, OFF_BWD, OFF_FWD

        active = [c for c, s in enumerate(self.scales) if s > 0]
        if len(active) != 1:
            marked = yuv_to_bgr(self.encode_yuv(bgr_to_yuv(frames.astype(jnp.float32)), wm))
            return jnp.round(jnp.clip(marked, 0.0, 255.0)).astype(jnp.uint8)

        c = active[0]
        b, h, w, _ = frames.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        planes = jnp.moveaxis(frames, -1, 1).astype(jnp.float32)  # [B, 3, H, W]
        bp, gp, rp = planes[:, 0], planes[:, 1], planes[:, 2]

        # channel plane + Haar LL in one fused pass
        cp = (M_FWD[c, 0] * bp[:, :h4, :w4] + M_FWD[c, 1] * gp[:, :h4, :w4]
              + M_FWD[c, 2] * rp[:, :h4, :w4] + OFF_FWD[c])
        ll = (cp[:, 0::2, 0::2] + cp[:, 0::2, 1::2] + cp[:, 1::2, 0::2] + cp[:, 1::2, 1::2]) * 0.5
        dll = self._ll_delta(ll, wm.reshape(-1), float(self.scales[c]))
        # upsample 2x2 (each LL delta spreads as delta/2 over its quad)
        du = jnp.repeat(jnp.repeat(dll, 2, axis=1), 2, axis=2) * 0.5
        if (h4, w4) != (h, w):
            du = jnp.zeros((b, h, w), jnp.float32).at[:, :h4, :w4].set(du)

        # color roundtrip (parity with the reference's double cvtColor) plus
        # the rank-1 delta, all as planar lincombs
        yuv = [
            M_FWD[k, 0] * bp + M_FWD[k, 1] * gp + M_FWD[k, 2] * rp + OFF_FWD[k]
            for k in range(3)
        ]
        yuv[c] = yuv[c] + du
        out = [
            M_BWD[k, 0] * (yuv[0] - OFF_BWD[0])
            + M_BWD[k, 1] * (yuv[1] - OFF_BWD[1])
            + M_BWD[k, 2] * (yuv[2] - OFF_BWD[2])
            for k in range(3)
        ]
        marked = jnp.stack(out, axis=-1)  # [B, H, W, 3]
        return jnp.round(jnp.clip(marked, 0.0, 255.0)).astype(jnp.uint8)

    def extract_frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        """[B, H, W, 3] uint8 -> [B, capacity] decoded watermark plane.

        Fused fast path: LL of the U channel straight from the uint8 frames
        (color row + Haar 2x2 sum in one pass), then the block decode.
        """
        b, h, w, _ = frames.shape
        (nbh, nbw), capacity = block_grid((h, w), self.blk)
        ll = self._ll_from_frames(frames.astype(jnp.float32), 1)
        m = image_to_soa(ll[:, : nbh * self.blk, : nbw * self.blk], self.blk)
        scale = float(self.scales[1])
        s0, _, _ = top_triplet_soa(m)  # DCT omitted (module docstring)
        bits = (jnp.mod(s0, scale) > scale * 0.5).astype(jnp.float32)
        return jnp.pad(bits, ((0, 0), (0, capacity - nbh * nbw)))
