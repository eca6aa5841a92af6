"""Video segmentation on a fixed-duration grid.

With an ffmpeg binary: re-encode with forced keyframes at boundaries
(reference: tests/mark_video_to_hls.py:45-71).  Without one: frame-exact
chunking through the reader/writer stack —
every segment gets exactly round(duration * fps) frames, which is *more*
precise than keyframe-dependent cutting and makes leak re-segmentation
align perfectly.  ``.rawv`` input keeps ``.rawv`` segments (lossless, and no
codec library needed); anything else is chunked into MJPEG-AVI.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..io import open_reader, open_writer
from ..io.ffmpeg import have_ffmpeg, segment_video_ffmpeg


def frames_per_segment(fps: float, segment_duration: float) -> int:
    return max(1, int(round(fps * segment_duration)))


def segment_video(
    input_file,
    segments_dir,
    segment_duration: float = 2.0,
    use_ffmpeg: bool | None = None,
    quality: int = 95,
):
    """Split into segment_000.<ext>, ... ; returns sorted list of paths."""
    segments_dir = Path(segments_dir)
    segments_dir.mkdir(parents=True, exist_ok=True)
    if use_ffmpeg is None:
        use_ffmpeg = have_ffmpeg()
    if use_ffmpeg:
        segment_video_ffmpeg(
            input_file, str(segments_dir / "segment_%03d.mp4"), segment_duration
        )
        return sorted(segments_dir.glob("segment_*.mp4"))

    ext = ".rawv" if Path(input_file).suffix == ".rawv" else ".avi"
    reader = open_reader(input_file)
    n_per = frames_per_segment(reader.fps, segment_duration)
    fps = reader.fps
    paths = []
    idx = 0
    try:
        while True:
            got = 0
            writer = None
            while got < n_per:
                batch = reader.read_batch(min(16, n_per - got))
                if batch is None:
                    break
                if writer is None:
                    p = segments_dir / f"segment_{idx:03d}{ext}"
                    writer = open_writer(p, reader.width, reader.height, reader.fps, quality)
                    paths.append(p)
                writer.write_batch(batch)
                got += len(batch)
            if writer is not None:
                writer.close()
            if got < n_per:
                break
            idx += 1
    finally:
        reader.close()
    _write_audio_sidecars(input_file, paths, n_per, fps)
    return sorted(paths)


def _write_audio_sidecars(input_file, segment_paths, n_per: int, fps: float):
    """Stream-copy the source's audio into per-segment sidecar files.

    cv2 re-encode drops audio, so the audio slice for segment i (time range
    [i, i+1) * n_per/fps, matching the frame-exact video grid) rides in
    ``segment_i.audio.mp4`` and is muxed back by the splice/download paths
    (io/mp4.py audio_sidecar).  No-op when the source has no parseable
    audio track (non-MP4 input, video-only file)."""
    try:
        from ..io.mp4 import audio_sidecar, read_mp4, slice_track_by_time, write_mp4

        audio = read_mp4(input_file).audio()
    except Exception:
        return
    if audio is None or not audio.samples or not fps:
        return
    seg_seconds = n_per / fps
    for i, seg in enumerate(segment_paths):
        part = slice_track_by_time(audio, i * seg_seconds, (i + 1) * seg_seconds)
        if part.samples:
            write_mp4(audio_sidecar(seg), [part])
