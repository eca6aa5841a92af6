"""Frame readers: batched sources of uint8 RGB frames.

Unlike the reference's one-frame-at-a-time pipe read (reference:
src/offmark/video/frame_reader.py:53-64), readers here expose
``read_batch(n) -> [k, H, W, 3] | None`` so the pipeline can feed the device
whole batches and overlap decode with compute.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional

import numpy as np

RAWV_MAGIC = b"VFPRAWV1"


class FrameReader:
    """Protocol: batched uint8 RGB frame source."""

    width: int
    height: int
    fps: float = 30.0

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        """Up to n frames as uint8 [k, H, W, 3] (RGB); None at end of stream."""
        raise NotImplementedError

    def read(self) -> Optional[np.ndarray]:
        """Single frame [H, W, 3] or None (reference-compatible shape)."""
        b = self.read_batch(1)
        return None if b is None else b[0]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArrayReader(FrameReader):
    """In-memory source — the ffmpeg-less test seam."""

    def __init__(self, frames: np.ndarray, fps: float = 30.0):
        assert frames.ndim == 4 and frames.shape[-1] == 3
        self.frames = np.ascontiguousarray(frames, dtype=np.uint8)
        self.height, self.width = frames.shape[1:3]
        self.fps = fps
        self._pos = 0

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        if self._pos >= len(self.frames):
            return None
        out = self.frames[self._pos : self._pos + n]
        self._pos += len(out)
        return out


class Cv2Reader(FrameReader):
    """Any container OpenCV's bundled ffmpeg can decode (H.264, MJPEG, ...).

    cv2 yields BGR; we flip to file byte order (RGB) so downstream math sees
    exactly what the reference's rawvideo rgb24 pipe produced.
    """

    def __init__(self, file):
        import cv2

        self.file = str(file)
        self.cap = cv2.VideoCapture(self.file)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {file}")
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        import cv2

        out = []
        for _ in range(n):
            ok, frame = self.cap.read()
            if not ok:
                break
            out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))  # -> file order
        if not out:
            return None
        return np.stack(out)

    def close(self):
        self.cap.release()


class RawVideoReader(FrameReader):
    """Reader for the exact-transport raw format written by RawVideoWriter."""

    def __init__(self, file):
        self.f = open(file, "rb")
        magic = self.f.read(8)
        if magic != RAWV_MAGIC:
            self.f.close()
            raise IOError(f"not a VFP raw video file: {file}")
        self.width, self.height, fps_num, fps_den = struct.unpack("<IIII", self.f.read(16))
        self.fps = fps_num / max(fps_den, 1)
        self._frame_bytes = self.width * self.height * 3

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        buf = self.f.read(self._frame_bytes * n)
        if not buf:
            return None
        k = len(buf) // self._frame_bytes
        if k * self._frame_bytes != len(buf):
            raise IOError("truncated raw video file")
        return np.frombuffer(buf, np.uint8).reshape(k, self.height, self.width, 3)

    def close(self):
        self.f.close()


def open_reader(file) -> FrameReader:
    """Pick a reader by extension/magic: .rawv -> RawVideoReader, else cv2
    (or an ffmpeg pipe when the binary is available)."""
    p = Path(file)
    if p.suffix == ".y4m":
        from .y4m import Y4MReader

        return Y4MReader(file)
    if p.suffix == ".rawv":
        try:
            from ..native import NativeRawVideoReader

            return NativeRawVideoReader(file)
        except Exception:
            return RawVideoReader(file)
    from .ffmpeg import have_ffmpeg, FFmpegPipeReader

    if have_ffmpeg():
        return FFmpegPipeReader(file)
    return Cv2Reader(file)
