"""Trusted NumPy/cv2 oracle of the reference per-frame algorithms.

Written from the algorithm definitions in SURVEY.md / the reference math
(NOT imported from the reference — pywt is unavailable in this environment,
so the Haar step is the standard orthonormal butterfly, which is exactly what
pywt's 'haar' computes).  Used only by tests as the golden implementation the
device codecs must match, and by bench.py as the measured CPU baseline.
"""

from __future__ import annotations

import cv2
import numpy as np


def haar_dwt2_np(x):
    a, b = x[0::2, 0::2], x[0::2, 1::2]
    c, d = x[1::2, 0::2], x[1::2, 1::2]
    return (
        (a + b + c + d) * 0.5,
        (a - b + c - d) * 0.5,
        (a + b - c - d) * 0.5,
        (a - b - c + d) * 0.5,
    )


def haar_idwt2_np(ll, lh, hl, hh):
    h2, w2 = ll.shape
    out = np.empty((h2 * 2, w2 * 2), ll.dtype)
    out[0::2, 0::2] = (ll + lh + hl + hh) * 0.5
    out[0::2, 1::2] = (ll - lh + hl - hh) * 0.5
    out[1::2, 0::2] = (ll + lh - hl - hh) * 0.5
    out[1::2, 1::2] = (ll - lh - hl + hh) * 0.5
    return out


def embed_frame_yuv(yuv, wm_flat, scales=(0, 15, 0), blk=4):
    """Reference DwtDctSvd embed on one float32 YUV frame (in-place semantics)."""
    yuv = yuv.copy()
    h, w, _ = yuv.shape
    h4, w4 = h // 4 * 4, w // 4 * 4
    for ch, scale in enumerate(scales):
        if scale <= 0:
            continue
        ll, lh, hl, hh = haar_dwt2_np(yuv[:h4, :w4, ch])
        c = 0
        for i in range(ll.shape[0] // blk):
            for j in range(ll.shape[1] // blk):
                b = ll[i * blk : (i + 1) * blk, j * blk : (j + 1) * blk]
                u, s, v = np.linalg.svd(cv2.dct(b))
                s[0] = (s[0] // scale + 0.25 + 0.5 * wm_flat[c]) * scale
                ll[i * blk : (i + 1) * blk, j * blk : (j + 1) * blk] = cv2.idct(
                    (u * s) @ v
                )
                c += 1
        yuv[:h4, :w4, ch] = haar_idwt2_np(ll, lh, hl, hh)
    return yuv


def decode_frame_yuv(yuv, scales=(0, 15, 0), blk=4):
    """Reference DwtDctSvd decode: [capacity] float 0/1 plane (zero padded)."""
    h, w, _ = yuv.shape
    h4, w4 = h // 4 * 4, w // 4 * 4
    capacity = h * w // 64
    out = np.zeros(capacity)
    ll, *_ = haar_dwt2_np(np.ascontiguousarray(yuv[:h4, :w4, 1]))
    c = 0
    for i in range(ll.shape[0] // blk):
        for j in range(ll.shape[1] // blk):
            b = ll[i * blk : (i + 1) * blk, j * blk : (j + 1) * blk]
            s = np.linalg.svd(np.ascontiguousarray(cv2.dct(np.ascontiguousarray(b))), compute_uv=False)
            out[c] = float((s[0] % scales[1]) > scales[1] * 0.5)
            c += 1
    return out


def mark_frame_u8(frame_u8, wm_flat, scales=(0, 15, 0)):
    """Full reference frame path: uint8 -> cv2 color -> embed -> uint8."""
    yuv = cv2.cvtColor(frame_u8.astype(np.float32), cv2.COLOR_BGR2YUV)
    marked = embed_frame_yuv(yuv, wm_flat, scales)
    bgr = cv2.cvtColor(marked, cv2.COLOR_YUV2BGR)
    return np.around(np.clip(bgr, 0, 255)).astype(np.uint8)


def extract_frame_u8(frame_u8, scales=(0, 15, 0)):
    yuv = cv2.cvtColor(frame_u8.astype(np.float32), cv2.COLOR_BGR2YUV)
    return decode_frame_yuv(yuv, scales)
