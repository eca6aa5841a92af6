"""Per-segment variant marking + verification.

Reference behaviour: for every segment x copy, re-open the segment, decode it
frame by frame, embed, re-encode (reference: tests/mark_video_to_hls.py:73-109,
336-354), then verify each marked file with another full decode per candidate
(reference: :213-294).  Batched redesign: each segment's frames are decoded ONCE
into a device batch and all N copy variants are marked from that same batch;
verification decodes each marked file once and compares the majority pattern
against the expected payload.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..io import open_reader, open_writer
from ..pipeline import FrameExtractor, FrameMarker, MultiMarker
from ..wm import DeShuffler, DwtDctSvd, Shuffler
from .payloads import payload_for_segment

logger = logging.getLogger(__name__)


@dataclass
class MarkedSegment:
    file: str
    segment_number: int
    copy_index: int
    payload: list = field(default_factory=list)


def _read_all(file):
    # .rawv fast path: one np.fromfile of the whole segment.  The native
    # ring reader's per-open cost (thread spawn + ring alloc) dominates on
    # the few-frame segments HLS produces — 30x slower than a plain read.
    if str(file).endswith(".rawv"):
        import struct

        from ..io.readers import RAWV_MAGIC

        with open(file, "rb") as f:
            head = f.read(24)
            if head[:8] == RAWV_MAGIC:
                # corrupt headers (truncated, zero dims) must surface as
                # IOError: the pipelined verify/trace callers tolerate
                # per-file IOError as (None, 0.0), not struct.error
                if len(head) < 24:
                    raise IOError(f"truncated rawv header: {file}")
                w, h, fps_num, fps_den = struct.unpack("<IIII", head[8:])
                if h == 0 or w == 0:
                    raise IOError(f"invalid rawv dims {w}x{h}: {file}")
                data = np.fromfile(f, np.uint8)
                n = data.size // (h * w * 3)
                if n == 0:
                    raise IOError(f"empty segment: {file}")
                return (data[: n * h * w * 3].reshape(n, h, w, 3),
                        fps_num / max(fps_den, 1))
    reader = open_reader(file)
    chunks = []
    try:
        fps = reader.fps
        while True:
            b = reader.read_batch(32)
            if b is None:
                break
            chunks.append(b)
    finally:
        reader.close()
    if not chunks:
        raise IOError(f"empty segment: {file}")
    return np.concatenate(chunks), fps


def mark_segments(
    segments,
    marked_dir,
    copies: int = 1,
    key: int = 0,
    codec=None,
    batch_size: int = 16,
    quality: int = 95,
    out_ext: str | None = None,
    resume: bool = False,
    first_segment_number: int = 0,
    stats: dict | None = None,
):
    """Mark every segment in ``copies`` variants.

    Returns (marked: list[MarkedSegment], segment_payloads, segment_copies) —
    the dicts use the reference's JSON manifest schemas
    (reference: tests/mark_video_to_hls.py:406-427).

    When ``stats`` is a dict it is populated with per-stage busy seconds
    (decode / host_ll / dispatch / link_fetch / reconstruct / encode_write)
    plus wall seconds.  The host pipeline overlaps stages across threads, but
    on a single host core the host-stage busy times still sum to host-busy
    wall; link_fetch is time blocked on device->host transfers.
    """
    codec = codec or DwtDctSvd()
    marked_dir = Path(marked_dir)
    marked_dir.mkdir(parents=True, exist_ok=True)
    from ..io.ffmpeg import have_ffmpeg

    if out_ext is None:
        if segments and all(Path(s).suffix == ".rawv" for s in segments):
            out_ext = ".rawv"  # raw in, raw out: no codec library needed
        else:
            out_ext = ".mp4" if have_ffmpeg() else ".avi"

    marked: list[MarkedSegment] = []
    segment_payloads: dict = {}
    segment_copies: dict = {"segments": {}}
    generator = Shuffler(key=key)

    plans = [
        (
            seg_idx,
            seg_file,
            [
                c for c in range(copies)
                if not (resume
                        and (marked_dir / f"marked_seg{seg_idx}_copy{c}{out_ext}").exists())
            ],
        )
        for seg_idx, seg_file in enumerate(segments, start=first_segment_number)
    ]

    # host pipeline: decode segment i+1 on a thread while segment i marks, a
    # writer thread JPEG-encodes behind the device (so each batch's chip +
    # link latency hides under the previous batch's encode, and segment i+1's
    # decode/submit proceeds while segment i's files still flush)
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    decode_futs: dict = {}
    t_wall0 = time.perf_counter()
    # decode/host_ll/dispatch/link_fetch/reconstruct/encode_write are BUSY
    # seconds; decode_wait/queue_wait (main thread blocked on the decode
    # future / the bounded writer queue) and writer_idle (writer blocked on
    # an empty queue) make the accounting complete: main-thread wall ≈
    # host_ll + dispatch + decode_wait + queue_wait + loop overhead
    ss = {"decode": 0.0, "host_ll": 0.0, "dispatch": 0.0, "link_fetch": 0.0,
          "recentre": 0.0, "host_qim": 0.0, "reconstruct": 0.0,
          "device_full": 0.0, "encode_write": 0.0, "decode_wait": 0.0,
          "queue_wait": 0.0, "writer_idle": 0.0}

    def _read_timed(file):
        t0 = time.perf_counter()
        out = _read_all(file)
        ss["decode"] += time.perf_counter() - t0
        return out

    def _prefetch(pi: int):
        if pi < len(plans) and plans[pi][2] and plans[pi][0] not in decode_futs:
            decode_futs[plans[pi][0]] = pool.submit(_read_timed, plans[pi][1])

    # bounded: each "mark" item holds an in-flight device handle + its source
    # frames, so maxsize is the pipeline depth (submits run ahead of the
    # link fetch + encode by up to 3 batches, across segment boundaries)
    wq: queue.Queue = queue.Queue(maxsize=3)
    werr: list = []
    broken: list = []  # files touched at/after the first writer error

    def _writer_loop():
        while True:
            t_idle = time.perf_counter()
            item = wq.get()
            ss["writer_idle"] += time.perf_counter() - t_idle
            if item is None:
                return
            try:
                if werr:
                    # after an error: drain, but record every affected file so
                    # it can be unlinked — resume=True treats existing files as
                    # complete, so leaving truncated ones would silently skip
                    # their segments on re-run
                    broken.extend(item[-1])
                    if item[0] == "close":
                        for wtr in item[1].values():
                            try:
                                wtr.close()
                            except Exception:  # pragma: no cover - best effort
                                pass
                elif item[0] == "mark":
                    _, mm, handle, writers, todo, _paths = item
                    t0 = time.perf_counter()
                    out = mm.collect(handle)  # blocks on the link fetch here,
                    t1 = time.perf_counter()  # off the submitting thread
                    if mm._ll is None:  # lowlink times itself, finer-grained
                        ss["device_full"] += t1 - t0
                    for vi, c in enumerate(todo):
                        writers[c].write_batch(out[vi])
                    ss["encode_write"] += time.perf_counter() - t1
                else:
                    t0 = time.perf_counter()
                    for wtr in item[1].values():
                        wtr.close()
                    ss["encode_write"] += time.perf_counter() - t0
            except Exception as e:  # pragma: no cover - re-raised below
                werr.append(e)
                broken.extend(item[-1])

    wt = threading.Thread(target=_writer_loop, daemon=True)
    wt.start()

    # per-marker stage_seconds dicts (tiny) — NOT the markers themselves:
    # retaining every segment's MultiMarker (watermark stacks + bit-mask
    # caches) would grow without bound in segment count
    mm_stages: list = []
    packers: dict = {}  # (h, w) -> PackedTwoPlane shared across segments

    def _packer(h, w, n_variants):
        # two-plane device calls depend only on the LL, so one call can carry
        # frames of MANY segments (each marker selects its variants host-side
        # afterwards) — 6-frame HLS segments no longer pay one device call each
        if n_variants < 3:
            return None
        from ..pipeline.embedder import use_lowlink
        from ..pipeline.lowlink import default_wire

        if not use_lowlink(codec) or default_wire() == "host":
            return None  # host wire makes no device calls: nothing to pack
        if (h, w) not in packers:
            from ..pipeline.lowlink import PackedTwoPlane

            packers[(h, w)] = PackedTwoPlane(codec, pack=max(batch_size, 16))
        return packers[(h, w)]

    _prefetch(0)
    for pi, (seg_idx, seg_file, todo) in enumerate(plans):
        _prefetch(pi + 1)
        if werr:  # writer already failed: stop submitting device work
            break
        if todo:  # segment-level resume: decode only when some copy is missing
            t_dw = time.perf_counter()
            frames, fps = decode_futs.pop(seg_idx).result()  # decoded ONCE
            ss["decode_wait"] += time.perf_counter() - t_dw
            h, w = frames.shape[1:3]
            # all missing variants marked in ONE vmapped call per batch
            wms = [
                generator.generate_wm(
                    payload_for_segment(seg_idx, c), codec.wm_capacity((h, w, 3))
                )
                for c in todo
            ]
            mm = MultiMarker(codec, wms, batch_size=batch_size,
                             packer=_packer(h, w, len(todo)))
            paths = [str(marked_dir / f"marked_seg{seg_idx}_copy{c}{out_ext}") for c in todo]
            writers = {
                c: open_writer(
                    marked_dir / f"marked_seg{seg_idx}_copy{c}{out_ext}", w, h, fps, quality
                )
                for c in todo
            }
            if mm._ll is not None:
                mm_stages.append(mm._ll.stage_seconds)
            # free-running submits: the device + link work ahead of the
            # writer thread's fetch/encode by the queue depth, including
            # across segment boundaries (no per-segment drain)
            for start in range(0, len(frames), batch_size):
                if werr:
                    break
                handle = mm.submit(frames[start : start + batch_size])
                t_qw = time.perf_counter()
                wq.put(("mark", mm, handle, writers, todo, paths))
                ss["queue_wait"] += time.perf_counter() - t_qw
            wq.put(("close", writers, paths))
        # audio rides along: every variant of this segment shares the source
        # segment's audio sidecar (io/mp4.py audio_sidecar; splice paths mux
        # it back into the leaked/downloaded file)
        from ..io.mp4 import audio_sidecar

        src_audio = audio_sidecar(seg_file)
        seg_entry = []
        for copy_index in range(copies):
            payload = payload_for_segment(seg_idx, copy_index)
            out_file = marked_dir / f"marked_seg{seg_idx}_copy{copy_index}{out_ext}"
            if src_audio.exists():
                dst_audio = audio_sidecar(out_file)
                if not dst_audio.exists():
                    import shutil

                    shutil.copy2(src_audio, dst_audio)
            info = MarkedSegment(
                file=str(out_file),
                segment_number=seg_idx,
                copy_index=copy_index,
                payload=payload.tolist(),
            )
            marked.append(info)
            seg_entry.append(
                {"file": out_file.name, "payload": payload.tolist(), "copy_index": copy_index}
            )
            segment_payloads[f"{seg_idx}_{copy_index}"] = payload.tolist()
            logger.info("marked segment %d copy %d -> %s", seg_idx, copy_index, out_file)
        segment_copies["segments"][str(seg_idx)] = seg_entry
    for p in packers.values():  # dispatch any tail partial chunk now, not at
        p.flush()  # the writer's collect (device starts while writes finish)
    wq.put(None)
    wt.join()
    pool.shutdown(wait=False)
    for sd in mm_stages:  # summed after join: the writer thread owned the collects
        for sk, sv in sd.items():
            ss[sk] += sv
    for p in packers.values():  # shared dispatch/fetch seconds live here
        for sk, sv in p.stage_seconds.items():
            ss[sk] += sv
    if werr:
        # unlink every file touched at/after the failure so a resume=True
        # rerun re-marks those segments instead of trusting truncated output
        for p in set(broken):
            Path(p).unlink(missing_ok=True)
        raise werr[0]

    segment_copies.update(
        {
            "total_segments": len(segments),
            "copies_per_segment": copies,
            "total_marked_segments": len(marked),
        }
    )
    if stats is not None:
        wall = time.perf_counter() - t_wall0
        stats["wall_seconds"] = round(wall, 3)
        stats["stage_seconds"] = {k: round(v, 3) for k, v in ss.items()}
        host = (ss["decode"] + ss["host_ll"] + ss["recentre"] + ss["host_qim"]
                + ss["reconstruct"] + ss["encode_write"])
        stats["host_busy_seconds"] = round(host, 3)
        stats["link_device_wait_seconds"] = round(
            ss["dispatch"] + ss["link_fetch"] + ss["device_full"], 3)
        if packers:
            stats["packed_device_calls"] = sum(p.calls for p in packers.values())
    return marked, segment_payloads, segment_copies


def verify_segment(marked_file, expected_payload, codec=None, key: int = 0, batch_size: int = 16):
    """Decode a marked segment once; (majority_pattern, frequency, success).

    Success = majority pattern equals the expected payload (the reference
    additionally gates frequency >= 0.5 at the workflow level,
    tests/mark_video_to_hls.py:381).
    """
    codec = codec or DwtDctSvd()
    expected = np.asarray(expected_payload)
    # fixed threshold: QIM bit planes are 0/1, and the all-zero payload of
    # segment 0 copy 0 is unrecoverable under the reference's midpoint rule;
    # the extractor is memoized — per-segment loops must not re-trace
    from ..pipeline import cached_bit_extractor

    fx = cached_bit_extractor(codec, key, int(expected.size), batch_size)
    frames, _ = _read_all(marked_file)
    payloads = np.concatenate(
        [fx.extract(frames[s : s + batch_size]) for s in range(0, len(frames), batch_size)]
    )
    from collections import Counter

    counter = Counter(map(tuple, payloads.tolist()))
    pattern, count = counter.most_common(1)[0]
    freq = count / len(payloads)
    return np.array(pattern, np.uint8), freq, bool(np.array_equal(pattern, expected))


def segment_majorities(files, payload_len: int, codec=None, key: int = 0,
                       batch_size: int = 16, depth: int = 3):
    """Pipelined majority-vote decode over segment files.

    Two schedulings on top of the serial loop, with identical per-file
    votes: (1) decode file i+1 on a thread while earlier extracts wait on
    the device->host link (FrameExtractor.submit/collect); (2) frames are
    packed ACROSS file boundaries into uniform batch_size chunks — every
    device call has a fixed cost, and 6-frame HLS segments submitted
    file-at-a-time would use 1 call per file instead of 1 per batch_size
    frames.  Returns [(pattern, frequency), ...] in file order; (None, 0.0)
    for unreadable/empty files."""
    from collections import Counter, deque
    from concurrent.futures import ThreadPoolExecutor

    from ..pipeline import cached_bit_extractor

    codec = codec or DwtDctSvd()
    files = list(files)
    fx = cached_bit_extractor(codec, key, payload_len, batch_size)
    results: list = [(None, 0.0)] * len(files)
    votes: list = [[] for _ in files]  # per-file [n, payload_len] pieces
    pool = ThreadPoolExecutor(max_workers=1)
    futs: dict = {}
    inflight: deque = deque()  # (handle, [(file_idx, n), ...])
    pend_frames: list = []
    pend_meta: list = []
    pend_shape = None  # (H, W) of the chunk being packed

    def _prefetch(i):
        if i < len(files) and i not in futs:
            futs[i] = pool.submit(_read_all, files[i])

    def _flush():
        nonlocal pend_frames, pend_meta
        if not pend_frames:
            return
        chunk = (pend_frames[0] if len(pend_frames) == 1
                 else np.concatenate(pend_frames))
        inflight.append((fx.submit(chunk), pend_meta))
        pend_frames, pend_meta = [], []

    def _drain():
        handle, meta = inflight.popleft()
        bits = fx.collect(handle)
        off = 0
        for i, n in meta:
            votes[i].append(bits[off : off + n])
            off += n

    try:
        _prefetch(0)
        for i in range(len(files)):
            _prefetch(i + 1)
            try:
                frames, _ = futs.pop(i).result()
            except IOError:  # empty/unreadable segment -> (None, 0.0)
                continue
            if pend_shape != frames.shape[1:3]:
                _flush()  # mixed-dim inputs: never pack across a dim change
                pend_shape = frames.shape[1:3]
            pos = 0
            while pos < len(frames):
                room = batch_size - sum(n for _, n in pend_meta)
                take = min(room, len(frames) - pos)
                pend_frames.append(frames[pos : pos + take])
                pend_meta.append((i, take))
                pos += take
                if take == room:
                    _flush()
                    while len(inflight) > depth:
                        _drain()
        _flush()
        while inflight:
            _drain()
    finally:
        pool.shutdown(wait=False)
    for i, pieces in enumerate(votes):
        if not pieces:
            continue
        payloads = np.concatenate(pieces)
        counter = Counter(map(tuple, payloads.tolist()))
        pattern, count = counter.most_common(1)[0]
        results[i] = (np.array(pattern, np.uint8), count / len(payloads))
    return results


def verify_segments(marked, codec=None, key: int = 0, batch_size: int = 16,
                    depth: int = 3):
    """Pipelined verify over a list of MarkedSegment (or (file, payload)
    pairs).  Returns [(pattern, frequency, success), ...] in order — each
    element identical to verify_segment's result (same decode, same majority
    vote; only the scheduling differs).  All payloads must share one length
    (they do: payload_for_segment is fixed-width)."""
    items = [(m.file, m.payload) if isinstance(m, MarkedSegment) else tuple(m)
             for m in marked]
    if not items:
        return []
    payload_len = int(np.asarray(items[0][1]).size)
    maj = segment_majorities([f for f, _ in items], payload_len, codec=codec,
                             key=key, batch_size=batch_size, depth=depth)
    return [
        (pattern, freq,
         bool(pattern is not None
              and np.array_equal(pattern, np.asarray(payload))))
        for (pattern, freq), (_, payload) in zip(maj, items)
    ]


def write_manifests(base_dir, segment_payloads, segment_copies, segment_map=None, failed=None):
    """Emit the reference's JSON manifests (tests/mark_video_to_hls.py:406-434)."""
    base_dir = Path(base_dir)
    (base_dir / "segment_payloads.json").write_text(json.dumps(segment_payloads, indent=2))
    (base_dir / "segment_copies.json").write_text(json.dumps(segment_copies, indent=2))
    if segment_map is not None:
        (base_dir / "segment_mapping.json").write_text(
            json.dumps(
                {
                    "hls_to_watermarked": segment_map,
                    "description": "Maps HLS segment files to their source watermarked segment files",
                },
                indent=2,
            )
        )
    if failed:
        (base_dir / "failed_segments.json").write_text(json.dumps(failed, indent=2))
