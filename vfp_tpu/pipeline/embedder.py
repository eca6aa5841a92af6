"""Embedding driver: reader -> batched device mark -> writer, stages overlapped.

The reference processes one frame per loop iteration with everything serial
(reference: src/offmark/video/embedder.py:18-31).  Here frames move in
``[B, H, W, 3]`` batches; a reader thread decodes batch k+1 and a writer
thread encodes batch k-1 while the device computes batch k (the 3-stage
host pipeline from SURVEY.md §2.5).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field

import jax
import numpy as np

logger = logging.getLogger(__name__)

_SENTINEL = None


def use_lowlink(codec) -> bool:
    """LL-domain link transport policy (pipeline/lowlink.py): off unless the
    user asks for it with VFP_LOWLINK=1 or a VFP_LL_WIRE wire format, and
    only for codecs it supports.  VFP_LOWLINK=0 forces it off."""
    import os

    from .lowlink import lowlink_ok

    flag = os.environ.get("VFP_LOWLINK")
    if flag == "0" or not lowlink_ok(codec):
        return False
    return flag == "1" or bool(os.environ.get("VFP_LL_WIRE"))


class FrameMarker:
    """Binds a codec + spread watermark into a jitted uint8 batch transform.

    Pads partial batches to the compiled batch size so every video length
    reuses one executable per (B, H, W) shape.  With the low-link transport
    turned on (``use_lowlink``), the flagship codec routes through
    pipeline/lowlink.py: ~6x less up-traffic and ~12x less down-traffic on
    the host<->device link.
    """

    def __init__(self, codec, wm: np.ndarray, batch_size: int = 16):
        self.codec = codec
        self._wm_np = np.asarray(wm).reshape(-1)
        self.wm = None  # device copy, placed on first full-frame mark: the
        # host-wire lowlink path must never touch the backend (outage-proof)
        self.batch_size = batch_size
        self._ll = None
        if use_lowlink(codec):
            from .lowlink import LowLinkMarker

            self._ll = LowLinkMarker(codec, [self._wm_np], batch_size)
        self._fn = jax.jit(lambda f, w: codec.mark_frames(f, w))

    def mark(self, frames: np.ndarray) -> np.ndarray:
        if self._ll is not None:
            return self._ll.mark_all(frames)[0]
        if self.wm is None:
            self.wm = jax.numpy.asarray(self._wm_np, jax.numpy.float32)
        k = len(frames)
        if k < self.batch_size:
            pad = np.repeat(frames[-1:], self.batch_size - k, axis=0)
            frames = np.concatenate([frames, pad])
        out = self._fn(frames, self.wm)
        return np.asarray(out)[:k]


class MultiMarker:
    """Marks every watermark variant in one vmapped call per frame batch —
    the HLS copies axis amortizes kernel launches (and maps onto the
    'variant' mesh axis on multi-chip, parallel/sharded.py).  With the
    low-link transport turned on (``use_lowlink``) the flagship codec routes
    through it."""

    def __init__(self, codec, wms: np.ndarray, batch_size: int = 16, packer=None):
        self.codec = codec
        self._wms_np = np.stack([np.asarray(w).reshape(-1) for w in wms])
        self.wms = None  # device copy, placed lazily (see FrameMarker.wm)
        self.batch_size = batch_size
        self._ll = None
        if use_lowlink(codec):
            from .lowlink import LowLinkMarker

            self._ll = LowLinkMarker(codec, list(self._wms_np), batch_size,
                                     packer=packer)
        self._fn = jax.jit(jax.vmap(lambda f, w: codec.mark_frames(f, w), in_axes=(None, 0)))

    @property
    def n_variants(self) -> int:
        return len(self._wms_np)

    def submit(self, frames: np.ndarray):
        """Async dispatch (low-link only); pair with collect() to overlap
        device work + link transfers with host-side encode/write."""
        if self._ll is not None:
            return self._ll.submit(frames)
        return frames  # full-frame path computes in collect()

    def collect(self, handle) -> np.ndarray:
        if self._ll is not None:
            return self._ll.collect(handle)
        return self._mark_full(handle)

    def mark_all(self, frames: np.ndarray) -> np.ndarray:
        """[k, H, W, 3] -> [V, k, H, W, 3] uint8."""
        if self._ll is not None:
            return self._ll.mark_all(frames)
        return self._mark_full(frames)

    def _mark_full(self, frames: np.ndarray) -> np.ndarray:
        if self.wms is None:
            self.wms = jax.numpy.asarray(self._wms_np, jax.numpy.float32)
        k = len(frames)
        if k < self.batch_size:
            pad = np.repeat(frames[-1:], self.batch_size - k, axis=0)
            frames = np.concatenate([frames, pad])
        out = self._fn(frames, self.wms)
        return np.asarray(out)[:, :k]


@dataclass
class PipelineStats:
    frames: int = 0
    seconds: float = 0.0
    stage_seconds: dict = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0


class Embedder:
    """Drive reader -> marker -> writer to completion (reference API:
    Embedder(frame_reader, frame_embedder, frame_writer).start(),
    src/offmark/video/embedder.py:11-31)."""

    def __init__(self, frame_reader, frame_marker: FrameMarker, frame_writer, prefetch: int = 2):
        self.reader = frame_reader
        self.marker = frame_marker
        self.writer = frame_writer
        self.prefetch = prefetch

    def start(self) -> PipelineStats:
        t0 = time.perf_counter()
        in_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err: list = []

        def produce():
            try:
                while True:
                    batch = self.reader.read_batch(self.marker.batch_size)
                    if batch is None:
                        break
                    in_q.put(batch)
            except Exception as e:  # pragma: no cover - propagated below
                err.append(e)
            finally:
                in_q.put(_SENTINEL)

        def consume():
            try:
                while True:
                    batch = out_q.get()
                    if batch is _SENTINEL:
                        break
                    self.writer.write_batch(batch)
            except Exception as e:  # pragma: no cover
                err.append(e)
                # keep draining (discarding batches) until the sentinel so the
                # main loop's bounded out_q.put() can never block forever and
                # the recorded error is actually raised
                while out_q.get() is not _SENTINEL:
                    pass

        rt = threading.Thread(target=produce, daemon=True)
        wt = threading.Thread(target=consume, daemon=True)
        rt.start()
        wt.start()

        n = 0
        wait_s = compute_s = 0.0
        while True:
            t1 = time.perf_counter()
            batch = in_q.get()
            wait_s += time.perf_counter() - t1
            if batch is _SENTINEL:
                break
            t1 = time.perf_counter()
            out_q.put(self.marker.mark(batch))
            compute_s += time.perf_counter() - t1
            n += len(batch)
        out_q.put(_SENTINEL)
        rt.join()
        wt.join()
        self.reader.close()
        self.writer.close()
        if err:
            raise err[0]
        stats = PipelineStats(
            frames=n, seconds=time.perf_counter() - t0,
            stage_seconds={"read_wait": round(wait_s, 4), "compute": round(compute_s, 4)},
        )
        logger.info(
            "embedded %d frames in %.2fs (%.1f fps; read-wait %.2fs, compute %.2fs)",
            n, stats.seconds, stats.fps, wait_s, compute_s,
        )
        return stats
