"""Low-link transport for the flagship codec: move LL-band data, not frames.

When the host<->device link is the end-to-end bottleneck of a video
workflow (full 480p frames: ~0.9 MB up + 0.9 MB/variant down), this moves
less over it.  The DWT+DCT+SVD codec only ever *reads* the LL band of one YUV channel and only
*writes* a delta to that same band, so the link traffic can be LL-domain:

  up:   LL of the active channel, float16   [k, H/4*2, W/4*2]   (x6 smaller)
  down: QIM LL delta, int8 fixed-point /8   [V, k, hc, wc]      (x12 smaller)
        (V >= 3: [2, k, hc, wc] bit-conditional planes instead — the per-
        block delta depends on the watermark only through that block's bit,
        so the host selects; device work and down-leg become V-independent)

The host computes the LL cheaply (one cv2.transform row + a 2x2 pair-sum)
and reconstructs marked frames as ``clip(rint(x + du * M_BWD[:, chan]))`` —
for integer inputs the float color roundtrip of the reference
(reference: src/offmark/video/embedder.py:34-38) is exactly the identity
after rounding, so only the delta term matters.  Decode needs only the LL,
so extraction sends the f16 LL up and pulls back per-frame payloads (bytes).

Numerics: f16 LL quantization (<=0.125 ulp) and int8/8 delta quantization
(0.0625) perturb s0 by well under 1% of the QIM bin (scale 15, margin 3.75);
outputs may differ from the full-frame path by +-1 on rounding-boundary
pixels.  Payload recovery is identical (tests/test_lowlink.py).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

DLL_Q = 8.0  # int8 fixed-point scale: |dll| < 15 => |q| <= 120 < 127


def default_wire() -> str:
    """Up-leg wire format: 'u8' (default), 'f16', or 'host'
    (VFP_LL_WIRE=f16 / VFP_LL_WIRE=host).  'host' runs the whole mark/
    extract math as the device program's numpy twin — zero link traffic,
    zero backend use (see the host-only transport block comment).
    Unset: 'u8'.

    The f16 LL up-leg dominates the mark path's link traffic ~4:1 over the
    int8 delta down-leg (154 KB vs 38 KB per 480p frame).  'u8' ships dithered round(LL / 2) — one byte
    per LL pixel, half the traffic — and the collect-time recentring (see
    the block comment above recentre_dll) cancels the quantization's effect
    on the marked frames' QIM centering: decision parity with the exact
    full-frame path and off-centre-distance parity with the f16 wire are
    pinned by tests/test_lowlink.py::TestU8Wire.  The extract leg takes the
    raw ~0.58-rms s0 perturbation against the scale/4 margin (no correction
    possible read-side); extract decisions on centred content are unchanged
    (same tests).
    """
    wire = os.environ.get("VFP_LL_WIRE")
    if wire:
        if wire not in ("u8", "f16", "host"):
            raise ValueError(
                f"VFP_LL_WIRE={wire!r}: expected 'u8', 'f16' or 'host'")
        return wire
    return "u8"


@lru_cache(maxsize=None)
def _dither(hc: int, wc: int) -> np.ndarray:
    """Subtractive-dither phase pattern, 2x2-tiled {0, 0.5, 1, 1.5}.

    Smooth content makes the 16 LL entries of a QIM block quantize with
    IDENTICAL errors (E = e * ones), which shifts the dominant singular
    value by u^T E v = 4e — up to the full +-2^1 step and past the
    scale/4 = 3.75 margin (measured: 19% raw bit errors on blockwise-
    smooth frames with plain step-2 rounding).  Offsetting each cell's
    quantization lattice by one of four phases puts 4 cells of every 4x4
    block on each sublattice, so a constant block's MEAN error is the
    step-0.5 quantization of its value: |mean| <= 0.25, s0 shift <= 1.
    """
    i = np.arange(hc)[:, None] % 2
    j = np.arange(wc)[None, :] % 2
    return ((2 * i + j) * 0.5).astype(np.float32)


def _wire_bias(chan: int) -> float:
    """u8 wire bias: chroma LL is SIGNED (cv2's +0.5 float offset, not
    +128 — U/V LL spans ~[-224, 224]), so bias by 128 wire units to center
    it; the luma LL is [0, 511] and needs none."""
    return 0.0 if chan == 0 else 128.0


def wire_encode(ll16: np.ndarray, wire: str, chan: int) -> np.ndarray:
    """f16 LL -> wire array (dithered u8 at step 2, or f16 passthrough)."""
    if wire == "u8":
        p = _dither(*ll16.shape[-2:])
        return np.clip(
            np.rint((ll16.astype(np.float32) - p) * 0.5) + _wire_bias(chan),
            0.0, 255.0).astype(np.uint8)
    return ll16


def _wire_decode(llw, chan: int):
    """Wire array -> f32 LL on device (dtype-dispatched; jit traces once
    per input dtype, so this Python branch is static per compiled fn)."""
    import jax
    import jax.numpy as jnp

    if llw.dtype == jnp.uint8:
        hc, wc = llw.shape[-2], llw.shape[-1]
        i = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0) % 2
        j = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1) % 2
        p = (2 * i + j).astype(jnp.float32) * 0.5
        return (llw.astype(jnp.float32) - _wire_bias(chan)) * 2.0 + p
    return llw.astype(jnp.float32)


# -- u8-wire recentring -------------------------------------------------------
#
# The device computes each block's QIM delta from the QUANTIZED LL (X - E),
# so the marked frame's s0 lands off-centre by exactly e = u^T E v (up to
# second order).  The host knows E exactly, and the delta block IS du * u v^T,
# so for |du| large enough to carry the direction the fix is a pure rescale:
#
#   dll' = dll * (1 - <dll, E> / ||dll||_F^2)     (= (du - e) * u v^T)
#
# Blocks with |du| below WIRE_DU_MIN can't yield their direction from dll
# (int8 quantization noise dominates); for those (~2*WIRE_DU_MIN/scale of
# blocks) the host recomputes the delta outright from the TRUE LL block with
# a numpy twin of the device's power iteration.  Net: the u8 wire's marked
# frames are centred like the f16 wire's, at ~half the up-leg traffic.

WIRE_DU_MIN = 0.5  # ||dll||_F (= |du|) below which the rescale is noise

# Direction-reliability gate: the device's singular direction comes from the
# QUANTIZED block X - E, so when the content's own AC structure is comparable
# to the wire error's, the direction it finds is the *dither pattern's* (high
# spatial frequency), not the content's.  The rescale can centre s0 along that
# wrong direction — frame-level decode passes — but lossy chroma coding
# (MJPEG/H.264 quantizes HF chroma to zero) then wipes the delta entirely,
# while the exact path's delta on flat content is DC and survives.  (Worst
# case observed: constant LL 1.0 quantizes to all-zero wire bytes via
# round-half-even, so the device sees ONLY the dither.)  Blocks with
# AC(X) < GAMMA2 * AC(E) are therefore repaired from the true LL instead.
WIRE_DIR_GAMMA2 = 16.0  # content AC rms must exceed 4x the error AC rms


def _block_ac(a: np.ndarray, blk: int, nbh: int, nbw: int) -> np.ndarray:
    """Per-block AC energy ||B - mean(B)||_F^2 of [k, hc, wc] -> [k, nbh, nbw]."""
    v = (a[:, : nbh * blk, : nbw * blk].astype(np.float32)
         .reshape(a.shape[0], nbh, blk, nbw, blk))
    s = v.sum((2, 4))
    s2 = (v * v).sum((2, 4))
    return s2 - s * s * np.float32(1.0 / (blk * blk))


def _flat_blocks(ll16: np.ndarray, E: np.ndarray, blk: int,
                 nbh: int, nbw: int) -> np.ndarray:
    """[k, nbh, nbw] bool: blocks whose device-side direction is unreliable
    (see WIRE_DIR_GAMMA2 block comment)."""
    return (_block_ac(ll16, blk, nbh, nbw)
            < WIRE_DIR_GAMMA2 * _block_ac(E, blk, nbh, nbw))


def wire_error(ll16: np.ndarray, llw: np.ndarray, chan: int) -> np.ndarray:
    """E = the host's exact LL (f32) minus the device's wire-decoded view."""
    p = _dither(*ll16.shape[-2:])
    dec = (llw.astype(np.float32) - _wire_bias(chan)) * 2.0 + p
    return ll16.astype(np.float32) - dec


def _host_triplet(x: np.ndarray):
    """[m, n, n] -> (s0 [m], u [m, n], v [m, n]): numpy twin of
    ops.soa.top_triplet_soa(method='power') — same squaring count, so host
    and device agree on s0 to float noise (which only ever moves a QIM
    target to a neighbouring *valid* centre for the same bit)."""
    from ..ops.soa import _EPS, _V0

    n = x.shape[-1]
    g = np.einsum("mra,mrb->mab", x, x)
    for _ in range(5):
        norm = np.sqrt((g * g).sum((-2, -1), keepdims=True))
        g = g / np.maximum(norm, _EPS)
        g = g @ g
    v = g @ _V0[:n]
    vn = np.linalg.norm(v, axis=1, keepdims=True)
    v = np.where(vn > _EPS, v / np.maximum(vn, _EPS), _V0[:n])
    bv = np.einsum("mrc,mc->mr", x, v)
    s0 = np.linalg.norm(bv, axis=1)
    e0 = np.zeros_like(bv)
    e0[:, 0] = 1.0
    u = np.where(s0[:, None] > _EPS, bv / np.maximum(s0[:, None], _EPS), e0)
    return s0, u, v


def recentre_dll(dll_q: np.ndarray, E: np.ndarray, ll16: np.ndarray,
                 blk: int, scale: float, plane_bits: np.ndarray,
                 stats: dict | None = None) -> np.ndarray:
    """Recentre u8-wire deltas on the TRUE LL's s0 (see block comment above).

    dll_q [P, k, hc, wc] int8, E / ll16 [k, hc, wc], plane_bits [P, >=nb]
    (each plane's per-block bit, row-major blocks).  Returns corrected int8.
    When ``stats`` is given, records ``repair_frac`` — the fraction of
    blocks the exact-triplet repair recomputed (feeds _FlatAdapt).

    The big-block rescale (all but ~2*WIRE_DU_MIN/scale of blocks) runs in
    the native DLL when available (vfpio_recentre2: one fused int8 pass, no
    float temporaries — this was the largest single host stage of the
    u8-wire collect, ~3.9 ms/frame of numpy 6-d transposes at 480p; the
    direction-reliability gate shares the same block walk).  Small blocks
    (direction unrecoverable from the wire) and flat blocks (device
    direction dominated by the wire error — see WIRE_DIR_GAMMA2) are
    repaired either way by _repair_small_blocks with the exact host triplet.
    """
    P, k, hc, wc = dll_q.shape
    nbh, nbw = hc // blk, wc // blk
    if np.asarray(plane_bits).shape[-1] < nbh * nbw:
        # same geometry check as host_dll: the native repair indexes
        # bits[p*nb + block] and must never read past a too-short plane
        raise ValueError(
            f"plane_bits cover {np.asarray(plane_bits).shape[-1]} blocks, "
            f"frame grid has {nbh * nbw} — watermark generated for a "
            "smaller geometry than the frames being recentred")
    lib = _native_reconstruct()
    if lib is not None and hasattr(lib, "vfpio_recentre2"):
        import ctypes

        qc = np.ascontiguousarray(dll_q)
        Ec = np.ascontiguousarray(E, np.float32)
        Xc = np.ascontiguousarray(ll16, np.float32)
        out = qc.copy()
        small = np.zeros((P, k, nbh, nbw), np.uint8)
        lib.vfpio_recentre2(
            qc.ctypes.data_as(ctypes.c_char_p),
            Ec.ctypes.data_as(ctypes.c_void_p),
            Xc.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_char_p),
            small.ctypes.data_as(ctypes.c_char_p),
            P, k, hc, wc, blk,
            ctypes.c_float(DLL_Q), ctypes.c_float(WIRE_DU_MIN),
            ctypes.c_float(WIRE_DIR_GAMMA2),
        )
        smb = small.astype(bool)
        if stats is not None:
            stats["repair_frac"] = float(smb.mean())
        if smb.any():
            _repair_small_blocks(out, smb, ll16, blk, scale, plane_bits)
        return out
    flat = _flat_blocks(ll16, E, blk, nbh, nbw)  # [k, nbh, nbw]
    # numpy fallback: einsum over blocked *views* — no 6-d transpose
    # materialization (the previous .transpose().sum() form cost ~35% more)
    rh, rw = nbh * blk, nbw * blk
    db = dll_q[:, :, :rh, :rw].astype(np.float32)
    db *= np.float32(1.0 / DLL_Q)
    dv = db.reshape(P, k, nbh, blk, nbw, blk)
    Ev = np.ascontiguousarray(E[:, :rh, :rw], np.float32).reshape(
        k, nbh, blk, nbw, blk)
    num = np.einsum("pkabcd,kabcd->pkac", dv, Ev)   # <dll, E>
    den = np.einsum("pkabcd,pkabcd->pkac", dv, dv)  # ||dll||_F^2
    big = (den >= WIRE_DU_MIN * WIRE_DU_MIN) & ~flat[None]
    if stats is not None:
        stats["repair_frac"] = float((~big).mean())
    alpha = np.where(big, 1.0 - num / np.maximum(den, 1e-12),
                     1.0).astype(np.float32)
    db *= np.repeat(np.repeat(alpha, blk, axis=2), blk, axis=3)
    db *= np.float32(DLL_Q)
    out = dll_q.copy()
    out[:, :, :rh, :rw] = np.clip(np.rint(db), -127, 127).astype(np.int8)
    if not big.all():
        _repair_small_blocks(out, ~big, ll16, blk, scale, plane_bits)
    return out


def _repair_small_blocks(out: np.ndarray, small: np.ndarray,
                         ll16: np.ndarray, blk: int, scale: float,
                         plane_bits: np.ndarray) -> None:
    """Recompute below-floor blocks' wire deltas from the TRUE LL, in place.

    out [P, k, hc, wc] int8 wire units; small [P, k, nbh, nbw] bool.

    Hot path is the masked C++ kernel (vfpio_qim_repair: one triplet per
    flagged frame-block, shared across planes — flat content flags EVERY
    block, so grayscale video would otherwise pay a full numpy repair per
    frame); blk != 4 or a missing/old toolchain falls back to the numpy
    twin below."""
    P, k, nbh, nbw = small.shape
    lib = _native_reconstruct()
    if (lib is not None and blk == 4 and hasattr(lib, "vfpio_qim_repair")
            and out.flags["C_CONTIGUOUS"]):
        import ctypes

        nb = nbh * nbw
        pb = np.ascontiguousarray(
            (np.asarray(plane_bits)[:, :nb] > 0.5).astype(np.uint8))
        llc = np.ascontiguousarray(ll16, np.float16)
        mc = np.ascontiguousarray(small.astype(np.uint8))
        lib.vfpio_qim_repair(
            llc.ctypes.data_as(ctypes.c_void_p),
            mc.ctypes.data_as(ctypes.c_char_p),
            pb.ctypes.data_as(ctypes.c_char_p),
            out.ctypes.data_as(ctypes.c_char_p),
            P, k, out.shape[-2], out.shape[-1], ctypes.c_float(scale))
        return
    rh, rw = nbh * blk, nbw * blk
    # blocked view for vectorized scatter-back (flat content can flag
    # thousands of blocks per frame; a per-block Python loop would dominate).
    # Contiguity matters: reshape of a non-contiguous array returns a COPY
    # and the scatter would silently write into dead memory.
    vout = (out.reshape(P, k, nbh, blk, nbw, blk)
            if out.shape[-2] == rh and out.shape[-1] == rw
            and out.flags["C_CONTIGUOUS"] else None)
    ki, ii, ji = np.nonzero(small.any(0))
    Xb = (ll16[:, :rh, :rw].astype(np.float32)
          .reshape(k, nbh, blk, nbw, blk)
          .transpose(0, 1, 3, 2, 4))[ki, ii, ji]  # [m, blk, blk]
    s0, u, v = _host_triplet(Xb)
    base = np.floor(s0 / scale) + 0.25
    for p in range(P):
        sel = small[p, ki, ii, ji]
        if not sel.any():
            continue
        bit = plane_bits[p].reshape(-1)[ii[sel] * nbw + ji[sel]]
        ds = (base[sel] + 0.5 * bit.astype(np.float32)) * scale - s0[sel]
        blocks = np.clip(np.rint(
            (ds[:, None, None] * u[sel][:, :, None] * v[sel][:, None, :])
            * np.float32(DLL_Q)), -127, 127).astype(np.int8)
        if vout is not None:
            vout[p, ki[sel], ii[sel], :, ji[sel], :] = blocks
        else:  # LL grid not a block multiple: slice-wise (rare, small tail)
            for t, (kk, aa, cc) in enumerate(zip(ki[sel], ii[sel], ji[sel])):
                out[p, kk, aa * blk:(aa + 1) * blk,
                    cc * blk:(cc + 1) * blk] = blocks[t]


# -- host-only transport (wire='host') ----------------------------------------
#
# The flagship's LL-domain math is small: per 4x4 block, one Gram matrix,
# five batched squarings, two matvecs and an outer product (~0.7 kFLOP/block,
# ~3.4 MFLOP per 480p frame).  wire='host' (set explicitly with
# VFP_LL_WIRE=host) runs the mark/extract math as the numpy twin of the
# device program — zero link traffic, zero jax dispatch.


def host_dll(ll16: np.ndarray, codec, chan: int,
             plane_bits: np.ndarray) -> np.ndarray:
    """Numpy twin of _mark_fn/_mark_fn_2plane: f16 LL [k, hc, wc] +
    per-plane block bits [P, >= nb] -> int8 QIM LL delta [P, k, hc, wc].

    Same float association as the device path (s_new = (floor(s0/scale) +
    0.25 + 0.5*bit) * scale, delta assembled directly as ds*u*v^T), so
    decisions agree; s0 comes from the same squaring count as
    ops.soa.top_triplet_soa(method='power').  Hot path is the C++ kernel
    (native/vfpio.cpp vfpio_qim_dll: one pass per block, no temporaries,
    ~10x the NumPy twin below on the one host core); blk != 4 or a missing
    toolchain falls back to the NumPy path."""
    scale = float(codec.scales[chan])
    blk = codec.blk
    k, hc, wc = ll16.shape
    nbh, nbw = hc // blk, wc // blk
    rh, rw = nbh * blk, nbw * blk
    if np.asarray(plane_bits).shape[-1] < nbh * nbw:
        raise ValueError(
            f"plane_bits cover {np.asarray(plane_bits).shape[-1]} blocks, "
            f"frame grid has {nbh * nbw} — watermark generated for a "
            "smaller geometry than the frames being marked")
    lib = _native_reconstruct()
    if lib is not None and blk == 4:
        import ctypes

        P = len(plane_bits)
        nb = nbh * nbw
        pb = np.ascontiguousarray(
            (np.asarray(plane_bits)[:, :nb] > 0.5).astype(np.uint8))
        llc = np.ascontiguousarray(ll16, np.float16)
        out = np.empty((P, k, hc, wc), np.int8)
        lib.vfpio_qim_dll(
            llc.ctypes.data_as(ctypes.c_void_p),
            pb.ctypes.data_as(ctypes.c_char_p),
            out.ctypes.data_as(ctypes.c_char_p),
            P, k, hc, wc, scale)
        return out
    X = (ll16[:, :rh, :rw].astype(np.float32)
         .reshape(k, nbh, blk, nbw, blk)
         .transpose(0, 1, 3, 2, 4).reshape(-1, blk, blk))  # [k*nb, blk, blk]
    s0, u, v = _host_triplet(X)
    outer = u[:, :, None] * v[:, None, :]
    cell = np.floor(s0 / scale)
    P = len(plane_bits)
    out = np.zeros((P, k, hc, wc), np.int8)
    for p in range(P):
        bits = np.tile(plane_bits[p].reshape(-1)[: nbh * nbw].astype(np.float32), k)
        s_new = (cell + 0.25 + 0.5 * bits) * scale
        d = (s_new - s0)[:, None, None] * outer
        dq = np.clip(np.rint(d * DLL_Q), -127, 127).astype(np.int8)
        out[p, :, :rh, :rw] = (dq.reshape(k, nbh, nbw, blk, blk)
                               .transpose(0, 1, 3, 2, 4).reshape(k, rh, rw))
    return out


def host_extract_bits(ll16: np.ndarray, codec, chan: int,
                      capacity: int) -> np.ndarray:
    """Numpy twin of the extract fn: f16 LL [k, hc, wc] -> [k, capacity] f32
    decoded bits (zero-padded past the block grid, like decode_yuv).  Hot
    path is C++ (vfpio_qim_bits), same fallback rule as host_dll."""
    scale = float(codec.scales[chan])
    blk = codec.blk
    k, hc, wc = ll16.shape
    nbh, nbw = hc // blk, wc // blk
    lib = _native_reconstruct()
    if lib is not None and blk == 4:
        import ctypes

        llc = np.ascontiguousarray(ll16, np.float16)
        raw = np.empty((k, nbh * nbw), np.uint8)
        lib.vfpio_qim_bits(
            llc.ctypes.data_as(ctypes.c_void_p),
            raw.ctypes.data_as(ctypes.c_char_p),
            k, hc, wc, scale)
        return np.pad(raw.astype(np.float32),
                      ((0, 0), (0, capacity - nbh * nbw)))
    X = (ll16[:, : nbh * blk, : nbw * blk].astype(np.float32)
         .reshape(k, nbh, blk, nbw, blk)
         .transpose(0, 1, 3, 2, 4).reshape(-1, blk, blk))
    s0, _, _ = _host_triplet(X)
    bits = (np.mod(s0, scale) > scale * 0.5).astype(np.float32).reshape(k, -1)
    return np.pad(bits, ((0, 0), (0, capacity - nbh * nbw)))


def lowlink_ok(codec) -> bool:
    """Whether the LL-domain transport applies to this codec: the flagship
    DWT+DCT+SVD family with exactly one active channel."""
    scales = getattr(codec, "scales", None)
    if scales is None or not hasattr(codec, "_ll_delta"):
        return False
    return sum(1 for s in scales if s > 0) == 1


def active_channel(codec) -> int:
    return next(c for c, s in enumerate(codec.scales) if s > 0)


def host_ll(frames: np.ndarray, chan: int) -> np.ndarray:
    """[k, H, W, 3] uint8 BGR -> [k, h4/2, w4/2] float16 LL of YUV channel
    ``chan`` (cv2 float constants + orthonormal Haar LL = 2x2 sum / 2).

    Hot path is the fused C++ pass (native/vfpio.cpp vfpio_host_ll: one u8
    row-pair read -> one f16 LL row write, GIL released — the NumPy/cv2
    composition below walks ~5 freshly allocated full-res intermediates and
    is ~10x slower, allocator-bound).  Outputs match to 1 f16 ulp (different
    but valid f32 association; tests/test_native.py pins the agreement)."""
    from ..ops.color import M_FWD, OFF_FWD

    k, h, w, _ = frames.shape
    h4, w4 = h // 4 * 4, w // 4 * 4
    lib = _native_reconstruct()
    if lib is not None:
        import ctypes

        src = np.ascontiguousarray(frames)
        out = np.empty((k, h4 // 2, w4 // 2), np.float16)
        lib.vfpio_host_ll(
            src.ctypes.data_as(ctypes.c_char_p),
            out.ctypes.data_as(ctypes.c_void_p),
            k, h, w, h4, w4,
            float(M_FWD[chan, 0]), float(M_FWD[chan, 1]),
            float(M_FWD[chan, 2]), float(OFF_FWD[chan]),
        )
        return out
    import cv2

    row = np.ascontiguousarray(M_FWD[chan : chan + 1])
    c = cv2.transform(frames.reshape(k * h, w, 3).astype(np.float32), row)
    c = c.reshape(k, h, w)[:, :h4, :w4] + np.float32(OFF_FWD[chan])
    ll = (c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2])
    ll *= np.float32(0.5)
    return ll.astype(np.float16)


@lru_cache(maxsize=None)
def _delta_luts(chan: int):
    """Per-channel int16 LUTs: wire int8 value -> rounded pixel delta.

    For integer pixels x, clip(rint(x + d)) == clip(x + rint(d)) for every
    one of the 255 wire values and both nonzero channels (verified
    exhaustively over all (x, du, ch) — no float lands exactly on a .5
    boundary), so the whole float pipeline collapses to an int16 LUT add.
    """
    from ..ops.color import M_BWD

    luts = []
    du = np.arange(-128, 128, dtype=np.float32)
    for ch in range(3):
        coef = float(M_BWD[ch, chan])
        luts.append(
            None if coef == 0.0
            else np.rint(du * np.float32(coef * 0.5 / DLL_Q)).astype(np.int16)
        )
    return luts


def reconstruct(frames: np.ndarray, dll_q: np.ndarray, chan: int) -> np.ndarray:
    """[k, H, W, 3] uint8 + int8 LL delta -> marked uint8 frames.

    marked = clip(rint(x + upsample2x2(dll) * 0.5 * M_BWD[:, chan])); channels
    with a zero column coefficient (R for chan=1) pass through untouched.
    """
    return reconstruct_all(frames, dll_q[None], chan)[0]


def _native_reconstruct():
    """Load vfpio's fused reconstruct (None when no native lib/compiler)."""
    try:
        from ..native.build import load_vfpio

        return load_vfpio()
    except Exception:  # pragma: no cover - depends on toolchain presence
        return None


def reconstruct_all(frames: np.ndarray, dll_all: np.ndarray, chan: int) -> np.ndarray:
    """[k, H, W, 3] uint8 + [V, k, hc, wc] int8 deltas -> [V, k, H, W, 3].

    Hot path is the C++ fused pass (native/vfpio.cpp vfpio_reconstruct: one
    saturating-add sweep per row, GIL released); the NumPy fallback below is
    bit-identical (same int16 LUT add + clamp) and pinned so by test.
    """
    V = len(dll_all)
    k, h, w, _ = frames.shape
    hc, wc = dll_all.shape[-2:]
    lib = _native_reconstruct()
    if lib is not None:
        import ctypes

        luts = _delta_luts(chan)
        src = np.ascontiguousarray(frames)
        out = np.empty((V, k, h, w, 3), np.uint8)
        lut_ptrs = [
            None if l is None else l.ctypes.data_as(ctypes.c_void_p)
            for l in luts
        ]
        for v in range(V):
            dv = np.ascontiguousarray(dll_all[v], np.int8)
            lib.vfpio_reconstruct(
                src.ctypes.data_as(ctypes.c_char_p),
                dv.ctypes.data_as(ctypes.c_char_p),
                lut_ptrs[0], lut_ptrs[1], lut_ptrs[2],
                out[v].ctypes.data_as(ctypes.c_char_p),
                k, h, w, hc, wc,
            )
        return out
    h2, w2 = hc * 2, wc * 2
    idx = dll_all.astype(np.int16)
    idx += 128  # LUT index space
    out = np.repeat(frames[None], V, axis=0)
    for ch, lut in enumerate(_delta_luts(chan)):
        if lut is None:
            continue
        x16 = frames[:, :h2, :w2, ch].astype(np.int16).reshape(k, hc, 2, wc, 2)
        d = lut[idx]  # [V, k, hc, wc] int16
        for v in range(V):
            m = x16 + d[v][:, :, None, :, None]
            np.clip(m, 0, 255, out=m)
            out[v, :, :h2, :w2, ch] = m.astype(np.uint8).reshape(k, h2, w2)
    return out


@lru_cache(maxsize=None)
def _mark_fn(codec, n_variants: int):
    """jitted: (ll f16 [k, hc, wc], wms f32 [V, cap]) -> dll int8 [V, k, hc, wc]."""
    import jax
    import jax.numpy as jnp

    chan = active_channel(codec)
    scale = float(codec.scales[chan])

    @jax.jit
    def fn(ll16, wms):
        ll = _wire_decode(ll16, chan)
        dll = jnp.stack(
            [codec._ll_delta(ll, wms[v], scale) for v in range(n_variants)]
        )
        return jnp.clip(jnp.round(dll * DLL_Q), -127.0, 127.0).astype(jnp.int8)

    return fn


@lru_cache(maxsize=None)
def _mark_fn_2plane(codec):
    """jitted: ll f16 [k, hc, wc] -> int8 [2, k, hc, wc] — the QIM delta for
    every block under bit=0 and bit=1.

    The per-block embed delta u·(qim(s0, bit) − s0)·vᵀ depends on the
    watermark only through that block's bit, so ALL variants' deltas are
    selections from these two planes.  Device compute and down-leg traffic
    become V-independent; the host (which generated the watermarks) picks
    per block.  Bit-exact vs the per-variant path: int8 wire quantization is
    elementwise, so quantize-then-select == select-then-quantize.  Both
    planes come from ONE dominant-triplet solve (codec._ll_delta2): s0/u/v
    are bit-independent, so solving per plane would double the device work.
    """
    import jax
    import jax.numpy as jnp

    chan = active_channel(codec)
    scale = float(codec.scales[chan])

    @jax.jit
    def fn(ll16):
        d01 = codec._ll_delta2(_wire_decode(ll16, chan), scale)
        return jnp.clip(jnp.round(d01 * DLL_Q), -127.0, 127.0).astype(jnp.int8)

    return fn


class _FlatAdapt:
    """u8-wire flat-content hysteresis.

    When a collect's direction-reliability gate repaired (almost) every
    block, the device's deltas carried no information for that batch — the
    whole up-leg + device call + down-leg was wasted work on top of the
    host repair that produced the real answer.  After ON_AFTER consecutive
    such collects the marker routes submits through the host QIM twin
    (host_dll — decision-identical by construction), re-probing the device
    every PROBE_EVERY host batches so content that regains chroma
    structure moves back to the wire.  Scope: per PackedTwoPlane (shared
    across a workflow's segments) or per unpacked marker — never process
    -global, so one grayscale video cannot degrade an unrelated marker.
    """

    THRESH = 0.9      # repair fraction above which a batch counts as flat
    ON_AFTER = 2      # consecutive flat collects before switching
    PROBE_EVERY = 8   # every Nth host batch goes to the device anyway

    def __init__(self):
        self.streak = 0
        self.host_batches = 0

    def update(self, repair_frac: float) -> None:
        self.streak = self.streak + 1 if repair_frac > self.THRESH else 0

    def use_host(self) -> bool:
        if self.streak < self.ON_AFTER:
            return False
        self.host_batches += 1
        return self.host_batches % self.PROBE_EVERY != 0


class _Chunk:
    """One packed device call: LL pieces from >=1 submissions."""

    __slots__ = ("dev", "np", "once")

    def __init__(self):
        import threading

        self.dev = None  # device handle(s) after flush: [(dll_dev, k), ...]
        self.np = None  # materialized [2, n, hc, wc] int8
        self.once = threading.Lock()


class PackedTwoPlane:
    """Shared two-plane dispatcher: packs LL submissions from multiple
    LowLinkMarker instances (same codec + frame dims) into uniform
    ``pack``-frame device calls.

    Motivation: every device call and fetch has a fixed cost, and HLS
    segments are ~6 frames, so per-segment dispatch is call-bound.  The
    two-plane delta (``_mark_fn_2plane``) depends only on the LL — not on any
    segment's watermarks — so one call can serve frames of many segments and
    every instance selects its own variants host-side afterwards.

    Shape discipline: flushes happen at exactly ``pack`` frames; a forced
    partial flush (collect overtaking submit, or stream end) is decomposed
    into power-of-two calls, so the compiled-shape set is bounded by
    {pack, 2^i < pack} regardless of scheduling — nondeterministic shapes
    would mean nondeterministic multi-second XLA compiles inside timed runs.
    """

    def __init__(self, codec, pack: int = 16, wire: str | None = None):
        import threading

        assert lowlink_ok(codec)
        self.codec = codec
        self.wire = wire or default_wire()
        self.pack = int(pack)
        self.chan = active_channel(codec)
        self.adapt = _FlatAdapt()  # shared flat-content hysteresis: one
        # grayscale-video workflow learns ONCE, across all its segments
        self._fn = _mark_fn_2plane(codec)
        self._lock = threading.Lock()
        self._pend: list = []  # np f16 LL pieces
        self._pend_n = 0
        self._cur = _Chunk()
        self.stage_seconds = {"dispatch": 0.0, "link_fetch": 0.0}
        self.calls = 0

    def submit_ll(self, ll: np.ndarray):
        """[k, hc, wc] wire-encoded LL -> ticket: [(chunk, offset, n), ...].

        Wire encoding happens in the caller (LowLinkMarker.submit needs the
        encoded copy anyway for collect-time recentring); concatenation along
        the frame axis never changes a frame's encoding (the dither pattern
        is per-LL-position, not per-chunk)."""
        pieces = []
        with self._lock:
            if self._pend and (self._pend[0].shape[1:] != ll.shape[1:]
                               or self._pend[0].dtype != ll.dtype):
                self._flush_locked()  # dim/wire change: never mix in a chunk
            pos, k = 0, len(ll)
            while pos < k:
                take = min(self.pack - self._pend_n, k - pos)
                self._pend.append(ll[pos : pos + take])
                pieces.append((self._cur, self._pend_n, take))
                self._pend_n += take
                pos += take
                if self._pend_n == self.pack:
                    self._flush_locked()
        return pieces

    def _flush_locked(self):
        if not self._pend:
            return
        import time

        import jax.numpy as jnp

        llw = (self._pend[0] if len(self._pend) == 1
               else np.concatenate(self._pend))
        t0 = time.perf_counter()
        if len(llw) == self.pack:
            self._cur.dev = [(self._fn(jnp.asarray(llw)), self.pack)]
            self.calls += 1
        else:
            # forced partial flush: power-of-two ladder keeps shapes bounded
            devs, pos, rem = [], 0, len(llw)
            step = 1 << (self.pack.bit_length() - 1)
            while rem:
                while step > rem:
                    step >>= 1
                devs.append((self._fn(jnp.asarray(llw[pos : pos + step])), step))
                self.calls += 1
                pos += step
                rem -= step
            self._cur.dev = devs
        self.stage_seconds["dispatch"] += time.perf_counter() - t0
        self._cur = _Chunk()
        self._pend, self._pend_n = [], 0

    def flush(self):
        """Dispatch any pending partial chunk (stream end)."""
        with self._lock:
            self._flush_locked()

    def fetch(self, pieces) -> np.ndarray:
        """Ticket -> [2, k, hc, wc] int8 (one whole-chunk fetch, cached)."""
        import time

        for chunk, _, _ in pieces:
            if chunk.dev is None and chunk.np is None:
                with self._lock:
                    # re-check: only a still-pending chunk (== self._cur) may
                    # be flushed here; a racing submit may have flushed it
                    if chunk.dev is None and chunk.np is None:
                        self._flush_locked()
        out = []
        for chunk, off, n in pieces:
            with chunk.once:
                if chunk.np is None:
                    t0 = time.perf_counter()
                    chunk.np = np.concatenate(
                        [np.asarray(d) for d, _ in chunk.dev], axis=1)
                    self.stage_seconds["link_fetch"] += time.perf_counter() - t0
                    chunk.dev = None  # free device buffers
            out.append(chunk.np[:, off : off + n])
        return out[0] if len(out) == 1 else np.concatenate(out, axis=1)


class LowLinkMarker:
    """MultiMarker-compatible variant marker over the LL-domain transport.

    ``submit``/``collect`` split dispatch from the (link-bound) fetch so a
    pipelined caller can overlap device work + transfers with host encode.
    When a shared ``packer`` (PackedTwoPlane) is supplied and the two-plane
    path applies, device calls are packed across instances/segments.
    """

    def __init__(self, codec, wms, batch_size: int = 16, packer=None,
                 wire: str | None = None):
        assert lowlink_ok(codec), "LowLinkMarker requires a single-channel DwtDctSvd codec"
        self.codec = codec
        self.wire = wire or default_wire()
        self.chan = active_channel(codec)
        self.batch_size = batch_size
        self._wms_np = np.stack([np.asarray(w).reshape(-1) for w in wms]).astype(np.float32)
        self._wms = None  # device copy, lazily placed
        # V >= 3: ship the two bit-conditional delta planes and select on the
        # host (V-independent device work + down-leg); V <= 2: per-variant
        # planes are the same or less traffic, keep the direct path
        self._two_plane = len(self._wms_np) >= 3
        if self.wire == "host":  # no device calls: nothing to pack or trace
            self._packer = None
            self._fn = None
        else:
            self._packer = (packer if self._two_plane and packer is not None
                            and packer.codec is codec else None)
            self._fn = (_mark_fn_2plane(codec) if self._two_plane
                        else _mark_fn(codec, len(self._wms_np)))
        # u8-wire flat-content hysteresis; shared via the packer so a
        # grayscale workflow adapts across segments, per-marker otherwise
        self._adapt = (self._packer.adapt if self._packer is not None
                       else _FlatAdapt())
        self._masks: dict = {}  # (hc, wc) -> [V, hc, wc] bool, built lazily
        # per-stage busy seconds, accumulated across submit/collect calls
        # (single host core: these compete for the same CPU, so their sum
        # approximates host-busy wall; link_fetch is time blocked on the
        # device->host transfer in collect)
        self.stage_seconds = {"host_ll": 0.0, "dispatch": 0.0,
                              "link_fetch": 0.0, "recentre": 0.0,
                              "host_qim": 0.0, "reconstruct": 0.0}

    @property
    def n_variants(self) -> int:
        return len(self._wms_np)

    def submit(self, frames: np.ndarray):
        """Dispatch one batch; returns an opaque handle for collect()."""
        import time

        import jax.numpy as jnp

        if self._wms is None and not self._two_plane and self.wire != "host":
            self._wms = jnp.asarray(self._wms_np)
        k = len(frames)
        t0 = time.perf_counter()
        # no batch padding: the link is the bottleneck, so shipping pad rows
        # costs real wall (6-frame HLS segments padded to 8 = +33% traffic
        # both legs).  Exact shapes mean one jit trace per distinct k — HLS
        # segments are uniform-length, so that is 1-2 shapes per video, and
        # the persistent compile cache absorbs them across runs.
        ll = host_ll(frames, self.chan)
        t1 = time.perf_counter()
        corr = None
        # flat-content hysteresis: when recent collects repaired ~every
        # block, the device deltas carry no information here — compute this
        # batch with the (decision-identical) host twin instead of paying
        # the up-leg + call + down-leg for nothing (_FlatAdapt re-probes)
        host_route = (self.wire == "host"
                      or (self.wire == "u8" and self._adapt.use_host()))
        if host_route:
            nb = (ll.shape[1] // self.codec.blk) * (ll.shape[2] // self.codec.blk)
            pb = (np.repeat(np.arange(2, dtype=np.float32)[:, None], nb, 1)
                  if self._two_plane else self._wms_np[:, :nb])
            handle = (host_dll(ll, self.codec, self.chan, pb), frames, k,
                      "host")
        else:
            llw = wire_encode(ll, self.wire, self.chan)
            corr = (ll, llw) if self.wire == "u8" else None
            if self._packer is not None:
                handle = (self._packer.submit_ll(llw), frames, k, corr)
            elif self._two_plane:
                handle = (self._fn(jnp.asarray(llw)), frames, k, corr)
            else:
                handle = (self._fn(jnp.asarray(llw), self._wms), frames, k, corr)
        t2 = time.perf_counter()
        self.stage_seconds["host_ll"] += t1 - t0
        if host_route:
            self.stage_seconds["host_qim"] += t2 - t1
        elif self._packer is None:  # packer times its own (shared) dispatches
            self.stage_seconds["dispatch"] += t2 - t1
        return handle

    def _bit_masks(self, hc: int, wc: int) -> np.ndarray:
        """[V, hc, wc] bool: each variant's per-block bit, expanded to the LL
        pixel grid (blocks row-major, matching ops/soa.image_to_soa)."""
        key = (hc, wc)
        if key not in self._masks:
            blk = self.codec.blk
            nbh, nbw = hc // blk, wc // blk
            m = np.zeros((len(self._wms_np), hc, wc), bool)
            for v, wmv in enumerate(self._wms_np):
                bits = wmv[: nbh * nbw].reshape(nbh, nbw) > 0.5
                m[v, : nbh * blk, : nbw * blk] = np.repeat(
                    np.repeat(bits, blk, 0), blk, 1)
            self._masks[key] = m
        return self._masks[key]

    def collect(self, handle) -> np.ndarray:
        """Handle -> [V, k, H, W, 3] uint8 marked frames."""
        import time

        dll_dev, frames, k, corr = handle
        t0 = time.perf_counter()
        host_batch = isinstance(corr, str)  # "host": dll computed at submit
        if host_batch:
            dll = dll_dev
        elif self._packer is not None:
            dll = self._packer.fetch(dll_dev)  # [2, k, hc, wc] int8
        else:
            dll = np.asarray(dll_dev)[:, :k]  # [V or 2, k, hc, wc] int8
        t1 = time.perf_counter()
        if corr is not None and not host_batch:
            ll, llw = corr
            nb = (dll.shape[-2] // self.codec.blk) * (dll.shape[-1] // self.codec.blk)
            if self._two_plane:
                pb = np.repeat(np.arange(2, dtype=np.float32)[:, None], nb, 1)
            else:
                pb = self._wms_np[:, :nb]
            st: dict = {}
            dll = recentre_dll(dll, wire_error(ll, llw, self.chan), ll,
                               self.codec.blk,
                               float(self.codec.scales[self.chan]), pb,
                               stats=st)
            self._adapt.update(st.get("repair_frac", 0.0))
            self.stage_seconds["recentre"] += time.perf_counter() - t1
        t2 = time.perf_counter()
        if self._two_plane:
            masks = self._bit_masks(*dll.shape[-2:])  # [V, hc, wc]
            dll = np.where(masks[:, None, :, :], dll[1], dll[0])
        out = reconstruct_all(frames, dll, self.chan)
        if self._packer is None:  # packer times its own fetch (shared chunks)
            self.stage_seconds["link_fetch"] += t1 - t0
        self.stage_seconds["reconstruct"] += time.perf_counter() - t2
        return out

    def mark_all(self, frames: np.ndarray) -> np.ndarray:
        return self.collect(self.submit(frames))


class LowLinkExtractor:
    """FrameExtractor-compatible payload extractor over the LL transport."""

    def __init__(self, codec, degenerator, batch_size: int = 16,
                 wire: str | None = None):
        assert lowlink_ok(codec)
        self.codec = codec
        self.wire = wire or default_wire()
        self.degenerator = degenerator
        self.batch_size = batch_size
        self.chan = active_channel(codec)
        self._fn = None if self.wire == "host" else self._build()

    def _build(self):
        from functools import partial

        import jax
        import jax.numpy as jnp

        codec, deg, chan = self.codec, self.degenerator, self.chan
        scale = float(codec.scales[chan])

        @partial(jax.jit, static_argnums=1)
        def fn(ll16, capacity_pad):
            ll = _wire_decode(ll16, chan)
            hc, wc = ll.shape[1:]
            nbh, nbw = hc // codec.blk, wc // codec.blk
            from ..ops.soa import image_to_soa, top_triplet_soa

            m = image_to_soa(ll[:, : nbh * codec.blk, : nbw * codec.blk], codec.blk)
            # DCT omitted: orthogonal similarity preserves s0
            # (wm/dwt_dct_svd.py module docstring)
            s0, _, _ = top_triplet_soa(m)
            bits = (jnp.mod(s0, scale) > scale * 0.5).astype(jnp.float32)
            bits = jnp.pad(bits, ((0, 0), (0, capacity_pad)))
            return deg.degenerate_batch(bits)

        return fn

    def submit(self, frames: np.ndarray):
        """Upload + dispatch one batch; pair with collect() so a pipelined
        caller overlaps the next file's decode with this one's link fetch."""
        import jax.numpy as jnp

        k, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        from ..wm.dwt_dct_svd import block_grid

        (nbh, nbw), capacity = block_grid((h, w), self.codec.blk)
        ll = host_ll(frames, self.chan)
        if self.wire == "host":  # full decode on host: zero link traffic
            bits = host_extract_bits(ll, self.codec, self.chan, capacity)
            return (self.degenerator.degenerate_batch_np(bits), k)
        # exact-shape upload (no pad): verify decodes 6-frame segments with
        # batch_size=16, so padding tripled the (bottleneck) up-leg traffic
        llw = wire_encode(ll, self.wire, self.chan)
        return (self._fn(jnp.asarray(llw), capacity - nbh * nbw), k)

    def collect(self, handle) -> np.ndarray:
        out, k = handle
        return np.asarray(out)[:k]

    def extract(self, frames: np.ndarray) -> np.ndarray:
        return self.collect(self.submit(frames))
