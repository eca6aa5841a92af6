"""CLI for the vfp_tpu watermarking framework.

The reference's "CLI" is its runnable test scripts (reference: readme.md:16-21,
run.md:1-11 — tests/mark.py, tests/detect.py, tests/mark_video_to_hls.py,
tests/generate_leak.py, tests/detect_watermarks.py); this is the same surface
as proper subcommands:

    python -m vfp_tpu.cli mark INPUT OUTPUT [--payload 01100101] [--key 0]
    python -m vfp_tpu.cli detect INPUT [--payload-len 8] [--key 0]
    python -m vfp_tpu.cli hls-mark INPUT OUTDIR --copies 3 [--segment-duration 2]
    python -m vfp_tpu.cli leak COPIES_JSON [--pattern 012] [--random-seed N]
    python -m vfp_tpu.cli trace LEAKED OUTDIR [--payload-file F] [--max-copies 3]
    python -m vfp_tpu.cli durability INPUT OUTDIR [--segment-duration 2]
    python -m vfp_tpu.cli serve [--port 8000]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np


def _payload_bits(s: str) -> np.ndarray:
    return np.array([int(c) for c in s])


def _make_codec(args):
    """Codec from --codec."""
    from ..utils import VfpConfig

    return VfpConfig().make_codec(args.codec)


def _make_generator(codec_name: str, key: int, generator: str = "auto",
                    threshold: str = "fixed"):
    """Generator/degenerator pair valid for a codec (reference pairings:
    tests/test.py:59 — Shuffler/GrayScale with DwtDctSvd/Dct, CorrShuffler
    with DtcwtKey, BlockShuffler with DtcwtImg)."""
    from ..wm import (
        BlockShuffler,
        CorrShuffler,
        DeBlockShuffler,
        DeCorrShuffler,
        DeGrayScale,
        DeShuffler,
        GrayScale,
        Shuffler,
    )

    name = codec_name.lower()
    if name in ("dtcwtkey", "dtcwt_key"):
        return CorrShuffler(key=key), DeCorrShuffler(key=key)
    if name in ("dtcwtimg", "dtcwt_img"):
        return BlockShuffler(key=key), DeBlockShuffler(key=key)
    if generator == "grayscale":
        return GrayScale(key=key), DeGrayScale(key=key)
    return Shuffler(key=key), DeShuffler(key=key, threshold=threshold)


def cmd_mark(args):
    import numpy as np
    from ..io import open_reader, open_writer
    from ..pipeline import Embedder, FrameMarker
    from ..utils import VfpConfig

    codec = _make_codec(args)
    generator, _ = _make_generator(args.codec, args.key, getattr(args, "generator", "auto"))
    if args.wm_image:
        import cv2

        payload = cv2.imread(args.wm_image, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    else:
        payload = _payload_bits(args.payload)
    reader = open_reader(args.input)
    wm = generator.generate_wm(payload, codec.wm_capacity((reader.height, reader.width, 3)))
    writer = open_writer(args.output, reader.width, reader.height, reader.fps, args.quality)

    def run():
        return Embedder(reader, FrameMarker(codec, wm, args.batch_size), writer).start()

    if args.profile:
        from ..utils import profile_trace

        with profile_trace(args.profile):
            stats = run()
        print(f"profiler trace -> {args.profile}")
    else:
        stats = run()
    print(f"marked {stats.frames} frames in {stats.seconds:.2f}s ({stats.fps:.1f} fps)")
    if stats.stage_seconds:
        print(f"stages: {stats.stage_seconds}")


def cmd_detect(args):
    import numpy as np
    from ..io import open_reader
    from ..pipeline import Extractor, FrameExtractor
    from ..utils import VfpConfig
    from ..wm import DeCorrShuffler

    codec = _make_codec(args)
    _, deg = _make_generator(args.codec, args.key,
                             threshold=getattr(args, "threshold", "fixed"))
    from ..wm import DeBlockShuffler

    if isinstance(deg, DeBlockShuffler):
        # image watermark: recover one image per frame to --out-dir
        import cv2
        import jax.numpy as jnp
        from pathlib import Path as _P

        out_dir = _P(args.out_dir or "detected_wms")
        out_dir.mkdir(parents=True, exist_ok=True)
        deg.set_shape((args.wm_height, args.wm_width))
        reader = open_reader(args.input)
        i = 0
        while True:
            b = reader.read_batch(args.batch_size)
            if b is None:
                break
            planes = np.asarray(codec.extract_frames(jnp.asarray(b)))
            for p in planes:
                rec = deg.degenerate(p)
                cv2.imwrite(str(out_dir / f"wm_{i:04d}.png"),
                            np.clip(rec, 0, 255).astype(np.uint8))
                i += 1
        reader.close()
        print(f"recovered {i} watermark images -> {out_dir}/")
        return
    expected = None
    if getattr(args, "payload", None):
        expected = _payload_bits(args.payload)
        args.payload_len = len(expected)
    if hasattr(deg, "set_shape"):
        deg.set_shape((args.payload_len,))
    if isinstance(deg, DeCorrShuffler):
        # presence detection: report per-frame correlations
        reader = open_reader(args.input)
        corrs = []
        while True:
            b = reader.read_batch(args.batch_size)
            if b is None:
                break
            import jax.numpy as jnp

            planes = codec.extract_frames(jnp.asarray(b))
            corrs.extend(np.asarray(deg.correlation_batch(planes)).tolist())
        reader.close()
        present = sum(c > deg.threshold for c in corrs)
        print(f"frames: {len(corrs)}")
        print(f"watermark present in {present}/{len(corrs)} frames "
              f"(mean correlation {np.mean(corrs):.3f})")
        return
    res = Extractor(open_reader(args.input), FrameExtractor(codec, deg, args.batch_size)).start()
    pattern, freq = res.majority()
    for i, p in enumerate(res.payloads):
        logging.getLogger("vfp_tpu.cli").info("frame %d: %s", i, p.tolist())
    print(f"frames: {res.frames} ({res.fps:.1f} fps)")
    print(f"majority payload: {''.join(map(str, pattern))} (frequency {freq:.2f})")
    if expected is not None:
        ok = bool(np.array_equal(pattern, expected))
        print(f"matches expected payload: {ok}")
        if not ok:
            raise SystemExit(1)


def cmd_test_frame(args):
    """Single-image roundtrip (reference workflow: tests/test.py): embed into
    one image, write output + amplified diff, read back, decode, report."""
    import cv2
    import numpy as np
    import jax.numpy as jnp
    from ..utils import VfpConfig
    from ..wm import DeCorrShuffler

    codec = _make_codec(args)
    generator, deg = _make_generator(args.codec, args.key, getattr(args, "generator", "auto"))
    frame = cv2.imread(args.image, cv2.IMREAD_COLOR)
    if frame is None:
        raise SystemExit(f"cannot read image: {args.image}")
    if args.wm_image:
        payload = cv2.imread(args.wm_image, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    else:
        payload = _payload_bits(args.payload)
    cap = codec.wm_capacity(frame.shape)
    wm = generator.generate_wm(payload, cap)
    marked = np.asarray(
        codec.mark_frames(jnp.asarray(frame[None]), jnp.asarray(np.asarray(wm), jnp.float32))
    )[0]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(out_dir / "output.jpeg"), marked,
                [cv2.IMWRITE_JPEG_QUALITY, args.quality])
    diff = np.clip(
        (marked.astype(np.int32) - frame.astype(np.int32)) * 10 + 128, 0, 255
    ).astype(np.uint8)
    cv2.imwrite(str(out_dir / "diff.jpeg"), diff)
    psnr = 10 * np.log10(255**2 / max(np.mean((marked.astype(float) - frame.astype(float)) ** 2), 1e-12))
    print(f"marked image -> {out_dir/'output.jpeg'} (PSNR {psnr:.1f} dB)")

    readback = cv2.imread(str(out_dir / "output.jpeg"), cv2.IMREAD_COLOR)
    plane = np.asarray(codec.extract_frames(jnp.asarray(readback[None])))[0]
    if isinstance(deg, DeCorrShuffler):
        print(f"watermark present: {deg.degenerate(plane)}")
    elif args.wm_image:
        deg.set_shape(payload.shape)
        rec = deg.degenerate(plane)
        cv2.imwrite(str(out_dir / "degenerate.jpeg"), np.asarray(rec, np.float32))
        print(f"recovered watermark image -> {out_dir/'degenerate.jpeg'}")
    else:
        deg.set_shape(payload.shape)
        rec = deg.degenerate(plane.flatten())
        print(f"recovered payload: {''.join(map(str, rec))} "
              f"(expected {''.join(map(str, payload))})")


def cmd_hls_mark(args):
    from ..fingerprint import mark_segments, segment_video, write_hls_playlists
    from ..fingerprint.marker import verify_segments, write_manifests

    base = Path(args.output_dir)
    if args.clean and base.exists():
        import shutil

        shutil.rmtree(base)
    segments = segment_video(args.input, base / "segments", args.segment_duration)
    print(f"created {len(segments)} segments")
    workers = getattr(args, "workers", 1) or 1
    if getattr(args, "distributed", False):
        # multi-host farm: every host runs this same command against a shared
        # output dir; jax.distributed rank-shards the segment list and rank 0
        # merges manifest shards (parallel/farm.py:mark_segments_distributed)
        from ..parallel.farm import mark_segments_distributed

        marked, payloads, copies = mark_segments_distributed(
            segments, base / "marked_segments", copies=args.copies,
            key=args.key, batch_size=args.batch_size, quality=args.quality,
            out_ext=None,
            coordinator_address=getattr(args, "coordinator", None),
            num_processes=getattr(args, "num_processes", None),
            process_id=getattr(args, "process_id", None),
        )
        import jax

        if jax.process_index() != 0:
            print(f"rank {jax.process_index()}: shard done "
                  f"({len(marked)} marked segments); rank 0 owns the merge")
            return
    elif workers > 1:
        from ..parallel.farm import mark_segments_parallel

        marked, payloads, copies = mark_segments_parallel(
            segments, base / "marked_segments", copies=args.copies,
            key=args.key, workers=workers, batch_size=args.batch_size,
            quality=args.quality, out_ext=None,
        )
    else:
        marked, payloads, copies = mark_segments(
            segments, base / "marked_segments", copies=args.copies, key=args.key,
            batch_size=args.batch_size, quality=args.quality,
            resume=getattr(args, "resume", False),
        )
    failed = []
    for m, (pattern, freq, ok) in zip(
            marked, verify_segments(marked, key=args.key,
                                    batch_size=args.batch_size)):
        if not ok or freq < 0.5:
            failed.append(
                {
                    "segment": Path(m.file).name,
                    "segment_number": m.segment_number,
                    "copy_index": m.copy_index,
                    "expected_pattern": m.payload,
                    "detected_pattern": pattern.tolist() if pattern is not None else None,
                    "frequency": freq,
                }
            )
    master, playlist, seg_map, variants = write_hls_playlists(
        marked, base / "hls", copies=args.copies, segment_duration=args.segment_duration
    )
    write_manifests(base, payloads, copies, seg_map, failed)
    print("\n===== WATERMARK VERIFICATION RESULTS =====")
    if failed:
        print(f"Failed to properly watermark {len(failed)} segments:")
        for f in failed:
            print(f"  Segment {f['segment_number']} copy {f['copy_index']} ({f['segment']})")
    else:
        print("All segments were watermarked successfully!")
    print(f"master playlist: {master}")


def cmd_leak(args):
    from ..fingerprint import generate_leak

    leaked, info = generate_leak(
        args.copies_file, args.output_file, args.pattern, args.random_seed,
        create_hls=args.create_hls, segment_duration=args.segment_duration,
    )
    print(f"leaked video: {leaked}")
    print(f"pattern: {info['pattern_string']}")
    if "custom_hls_playlist" in info:
        print(f"custom HLS playlist: {info['custom_hls_playlist']}")
    if args.detect:
        base = Path(args.copies_file).parent
        ns = argparse.Namespace(
            input=str(leaked), output_dir=str(base / "detection"),
            payload_file=str(base / "segment_payloads.json"),
            copies_file=None, clean=False,
            segment_duration=args.segment_duration, max_copies=10, key=0,
        )
        cmd_trace(ns)
    if args.serve:
        # reference behavior: after --create-hls, serve the playback bundle
        # over HTTP with CORS headers (reference: tests/generate_leak.py:577-611
        # runs the generated cors_server.py from the HLS dir)
        if "custom_hls_playlist" not in info:
            print("--serve requires --create-hls (no HLS bundle was created)")
            return
        import functools
        from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

        hls_dir = Path(args.copies_file).parent / "hls"

        class _CorsHandler(SimpleHTTPRequestHandler):
            def end_headers(self):
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods", "GET, OPTIONS")
                self.send_header("Access-Control-Allow-Headers", "Content-Type")
                self.send_header("Cache-Control",
                                 "no-store, no-cache, must-revalidate")
                super().end_headers()

            def do_OPTIONS(self):
                self.send_response(200)
                self.end_headers()

        handler = functools.partial(_CorsHandler, directory=str(hls_dir))
        with ThreadingHTTPServer(("", args.serve_port), handler) as httpd:
            print(f"Serving HLS playback from {hls_dir} on port {args.serve_port}")
            print(f"Open http://localhost:{args.serve_port}/index.html  (Ctrl+C stops)")
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                print("\nServer stopped by user.")


def cmd_trace(args):
    from ..fingerprint import trace_leak

    out_dir = Path(args.output_dir)
    copies_file = getattr(args, "copies_file", None)
    # reference quirk preserved: a relative 'detection[/...]' output dir is
    # relocated next to the copies file when one is given
    # (reference: tests/detect_watermarks.py:286-292)
    if copies_file and (args.output_dir == "detection"
                        or args.output_dir.startswith("detection/")):
        out_dir = Path(copies_file).resolve().parent / args.output_dir
    if getattr(args, "clean", False) and out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    result = trace_leak(
        args.input, out_dir, args.payload_file,
        segment_duration=args.segment_duration, max_copies=args.max_copies, key=args.key,
    )
    print("\n===== WATERMARK DETECTION RESULTS =====")
    for s in result.segments:
        print(f"Segment {s.segment_number}: copy={s.detected_copy_index} freq={s.match_frequency:.2f}")
    print("\n===== DETECTION SUMMARY =====")
    print(f"Total segments: {len(result.segments)}")
    print(f"Success rate: {result.success_rate * 100:.2f}%")
    print("\n===== FINGERPRINT SEQUENCE =====")
    print(f"Copy sequence: {result.copy_sequence}")
    if result.fingerprint is not None:
        print(f"Copy fingerprint: {result.fingerprint}")


def cmd_durability(args):
    from ..workflows.durability import run_durability, run_durability_corr

    name = getattr(args, "codec", "dwtDctSvd")
    container = getattr(args, "container", None)
    alpha = getattr(args, "alpha", None)
    if name == "dtcwtKey":
        report = run_durability_corr(
            args.input, args.output_dir, segment_duration=args.segment_duration,
            quality=args.quality, key=args.key, container=container,
        )
    else:
        if name == "dct":
            from ..wm import DctQim

            codec = DctQim(alpha=alpha) if alpha is not None else DctQim()
        else:
            from ..wm import DwtDctSvd

            codec = (DwtDctSvd(scales=(0.0, alpha, 0.0))
                     if alpha is not None else DwtDctSvd())
        report = run_durability(
            args.input, args.output_dir, segment_duration=args.segment_duration,
            quality=args.quality, key=args.key, codec=codec, container=container,
        )
    print(json.dumps(report, indent=2))
    sys.exit(0 if report["is_successful"] else 1)


def cmd_serve(args):
    from ..serve.app import run_server

    run_server(host=args.host, port=args.port, data_dir=args.data_dir)


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s  %(message)s"
    )
    p = argparse.ArgumentParser(prog="vfp_tpu", description=__doc__)
    p.add_argument("--verbose", "-v", action="store_true",
                   help="enable DEBUG logging (incl. @trace decorators)")
    p.add_argument("--platform", default="default",
                   help="JAX platform override, passed to jax_platforms "
                        "verbatim: 'cpu' or 'cuda' (default: JAX's own "
                        "choice, which is the GPU when one is present)")
    sub = p.add_subparsers(dest="cmd", required=True)

    codecs = ["dwtDctSvd", "dct", "dtcwtKey", "dtcwtImg"]

    m = sub.add_parser("mark", help="embed a payload into every frame")
    m.add_argument("input"), m.add_argument("output")
    m.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    m.add_argument("--payload", default="01100101")
    m.add_argument("--wm-image", default=None, help="grayscale watermark image payload")
    m.add_argument("--generator", choices=["auto", "shuffler", "grayscale"], default="auto")
    m.add_argument("--key", type=int, default=0)
    m.add_argument("--batch-size", type=int, default=16)
    m.add_argument("--quality", type=int, default=95)
    m.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the run into DIR")
    m.set_defaults(fn=cmd_mark)

    d = sub.add_parser("detect", help="extract per-frame payloads")
    d.add_argument("input")
    d.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    d.add_argument("--payload-len", type=int, default=8)
    d.add_argument("--payload", default=None,
                   help="expected payload bits; sets --payload-len and prints match")
    d.add_argument("--key", type=int, default=0)
    d.add_argument("--threshold", choices=["midpoint", "fixed"], default="fixed")
    d.add_argument("--batch-size", type=int, default=16)
    d.add_argument("--out-dir", default=None, help="output dir for recovered images (dtcwtImg)")
    d.add_argument("--wm-height", type=int, default=64)
    d.add_argument("--wm-width", type=int, default=64)
    d.set_defaults(fn=cmd_detect)

    tf = sub.add_parser("test-frame", help="single-image embed/extract roundtrip")
    tf.add_argument("image")
    tf.add_argument("out_dir")
    tf.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    tf.add_argument("--payload", default="01100101")
    tf.add_argument("--wm-image", default=None)
    tf.add_argument("--generator", choices=["auto", "shuffler", "grayscale"], default="auto")
    tf.add_argument("--key", type=int, default=0)
    tf.add_argument("--quality", type=int, default=95, help="output JPEG quality")
    tf.set_defaults(fn=cmd_test_frame)

    h = sub.add_parser("hls-mark", help="segment, mark N variants, build HLS")
    h.add_argument("input"), h.add_argument("output_dir")
    h.add_argument("--copies", type=int, default=1)
    h.add_argument("--segment-duration", type=float, default=2.0)
    h.add_argument("--clean", action="store_true")
    h.add_argument("--resume", action="store_true",
                   help="skip segment variants whose marked files already exist")
    h.add_argument("--key", type=int, default=0)
    h.add_argument("--batch-size", type=int, default=16)
    h.add_argument("--quality", type=int, default=95)
    h.add_argument("--workers", type=int, default=1,
                   help="single-host process farm: fan segments over N "
                        "worker processes (parallel/farm.py)")
    h.add_argument("--distributed", action="store_true",
                   help="multi-host farm via jax.distributed rank sharding; "
                        "run the same command on every host against a shared "
                        "output dir")
    h.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator address (host:port); "
                        "omit for cluster auto-detect / env vars")
    h.add_argument("--num-processes", dest="num_processes", type=int, default=None)
    h.add_argument("--process-id", dest="process_id", type=int, default=None)
    h.set_defaults(fn=cmd_hls_mark)

    l = sub.add_parser("leak", help="splice a leaked copy from variants")
    l.add_argument("copies_file")
    l.add_argument("--output-file", default=None)
    l.add_argument("--pattern", default=None)
    l.add_argument("--random-seed", type=int, default=None)
    l.add_argument("--segment-duration", type=float, default=2.0)
    l.add_argument("--serve", action="store_true",
                   help="after --create-hls, serve the playback bundle over "
                        "HTTP with CORS headers until interrupted")
    l.add_argument("--serve-port", type=int, default=8000)
    l.add_argument("--create-hls", action="store_true",
                   help="emit a per-pattern HLS playlist + CORS server + player page")
    l.add_argument("--detect", action="store_true")
    l.set_defaults(fn=cmd_leak)

    t = sub.add_parser("trace", help="recover the fingerprint from a leak")
    t.add_argument("input"), t.add_argument("output_dir")
    t.add_argument("--payload-file", default=None)
    t.add_argument("--copies-file", default=None,
                   help="segment_copies.json; relocates a relative "
                        "'detection' output dir next to it (reference quirk)")
    t.add_argument("--clean", action="store_true",
                   help="remove the output dir before tracing")
    t.add_argument("--segment-duration", type=float, default=2.0)
    t.add_argument("--max-copies", type=int, default=3)
    t.add_argument("--key", type=int, default=0)
    t.set_defaults(fn=cmd_trace)

    u = sub.add_parser("durability", help="mark -> re-encode -> re-detect experiment")
    u.add_argument("input"), u.add_argument("output_dir")
    u.add_argument("--segment-duration", type=float, default=2.0)
    u.add_argument("--quality", type=int, default=90)
    u.add_argument("--key", type=int, default=0)
    u.add_argument("--codec", choices=["dwtDctSvd", "dct", "dtcwtKey"], default="dwtDctSvd",
                   help="dtcwtKey runs the correlation-identification variant")
    u.add_argument("--container", choices=["avi", "mp4"], default=None,
                   help="lossy channel: avi = MJPEG at --quality (intra-only), "
                        "mp4 = cv2 mp4v (inter-frame, 4:2:0 chroma)")
    u.add_argument("--alpha", type=float, default=None,
                   help="embedding strength override (QIM scale for dwtDctSvd/"
                        "dct); mp4v needs ~45/30 vs the 15/20 defaults")
    u.set_defaults(fn=cmd_durability)

    s = sub.add_parser("serve", help="run the fingerprinting HTTP service")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--data-dir", default="serve_data")
    s.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    if args.verbose:
        logging.getLogger().setLevel(logging.DEBUG)
    if args.platform != "default":
        import jax

        jax.config.update("jax_platforms", args.platform)
    from ..utils import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
