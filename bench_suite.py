"""Full benchmark battery over the BASELINE.md configs.

Measures, end to end, the five workloads named in BASELINE.md:
  1. 480p clip embed -> detect roundtrip (the reference mark.py/detect.py)
  2. 1080p full-video embed, batched (chip throughput, on-device loop)
  3. HLS per-segment multi-variant marking (hls-mark workflow)
  4. leak splice + trace (generate_leak + detect_watermarks workflow)
  5. multi-stream concurrent marking via the HTTP service

Writes bench_suite_report.json and prints a table.  Usage:
  python bench_suite.py [--platform cpu|default] [--quick]
(bench.py is the one-line benchmark.)

Device timings chain iterations in one on-device loop and end in
``block_until_ready``; compile time is excluded by a warm-up call.  Every
report names the device it ran on.  These are readings, not a benchmark
with fixed cells: that is still to be built.
"""

import argparse
import json
import signal
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from vfp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()


def natural_frames(rng, b, h, w):
    import numpy as np

    small = rng.rand(b, h // 8, w // 8, 3)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2) * 220 + rng.rand(b, h, w, 3) * 20
    return np.clip(f, 0, 255).astype(np.uint8)


def u8_carry(x, dep):
    """Constant-fold barrier for extract bench loops: carry x forward with a
    data dependency on ``dep`` (the decoded bits) at ~zero HBM cost.

    A full-frame barrier such as ``x + (0.0 * sum(bits)).astype(u8)``
    would add a whole u8 read+write per iteration to what is timed.  A
    one-pixel dynamic_update_slice keeps the dependency (x changes every
    iteration, so XLA cannot hoist the extract out of the fori_loop) and XLA
    updates the loop carry in place.
    """
    import jax
    import jax.numpy as jnp

    pix = (x[:1, :1, :1, :1] + jnp.sum(dep).astype(jnp.uint8)) % 251
    return jax.lax.dynamic_update_slice(x, pix, (0,) * x.ndim)


def hbm_gbps(fps, h, w, passes):
    """Achieved GB/s from the *mandatory* whole-frame u8 traffic only:
    ``passes`` u8 frame copies per processed frame (mark: read+write = 2,
    extract: read = 1; the bits output is negligible).  A lower bound on
    the device-memory traffic: un-fused intermediates move more."""
    return round(fps * h * w * 3 * passes / 1e9, 1)


def bench_roundtrip_480p(quick):
    """Config 1: 480p embed -> detect through real (lossy) files."""
    import numpy as np
    from vfp_tpu.io import ArrayReader, MjpegAviWriter, open_reader
    from vfp_tpu.pipeline import Embedder, Extractor, FrameExtractor, FrameMarker
    from vfp_tpu.wm import DeShuffler, DwtDctSvd, Shuffler

    rng = np.random.RandomState(0)
    n = 24 if quick else 96
    frames = natural_frames(rng, n, 480, 856)
    codec = DwtDctSvd()
    payload = np.array([0, 1, 1, 0, 0, 1, 0, 1])
    wm = Shuffler(key=0).generate_wm(payload, codec.wm_capacity(frames.shape[1:]))
    out = Path("bench_tmp_480p.avi")
    t0 = time.perf_counter()
    stats = Embedder(ArrayReader(frames), FrameMarker(codec, wm, 8),
                     MjpegAviWriter(out, 856, 480, quality=95)).start()
    embed_s = time.perf_counter() - t0
    deg = DeShuffler(key=0, threshold="fixed").set_shape(payload.shape)
    t0 = time.perf_counter()
    res = Extractor(open_reader(out), FrameExtractor(codec, deg, 8)).start()
    detect_s = time.perf_counter() - t0
    pattern, freq = res.majority()
    out.unlink(missing_ok=True)
    return {
        "frames": n,
        "batch": 8,
        "embed_fps_incl_io": round(n / embed_s, 2),
        "detect_fps_incl_io": round(n / detect_s, 2),
        "payload_recovered": bool((pattern == payload).all()),
        "majority_frequency": round(float(freq), 3),
    }


def bench_embed_1080p(quick):
    """Config 2: pure-chip 1080p embed throughput (on-device loop)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.fingerprint import payload_for_segment
    from vfp_tpu.wm import DwtDctSvd, Shuffler

    codec = DwtDctSvd()
    rng = np.random.RandomState(0)
    b = 8 if quick else 128
    frames = jnp.asarray(natural_frames(rng, b, 1080, 1920))
    wm = Shuffler(key=0).generate_wm(payload_for_segment(1, 2), codec.wm_capacity((1080, 1920, 3)))
    wm = jnp.asarray(np.asarray(wm).reshape(-1), jnp.float32)

    @partial(jax.jit, static_argnums=2)
    def loop(x, wm, n):
        def body(i, x):
            return codec.mark_frames(x, wm)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 96
    loop(frames, wm, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, wm, iters).block_until_ready()
    dt = time.perf_counter() - t0
    fps = b * iters / dt
    return {"batch": b, "embed_fps_chip": round(fps, 1),
            "hbm_gbps": hbm_gbps(fps, 1080, 1920, 2)}


def bench_dtcwt_1080p(quick):
    """Config 2b: DT-CWT spread-spectrum codec throughput on the device."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.wm.dtcwt_codecs import DtcwtKey

    codec = DtcwtKey()
    rng = np.random.RandomState(0)
    b = 4 if quick else 16
    frames = jnp.asarray(natural_frames(rng, b, 1080, 1920))
    wm = jnp.asarray(
        rng.randint(0, 2, codec.wm_capacity((1080, 1920, 3))), jnp.float32)

    # correctness on chip first: mark -> extract -> keyed correlation
    marked = codec.mark_frames(frames, wm)
    rec = np.asarray(codec.extract_frames(marked))
    corr = float(np.corrcoef(
        rec.reshape(b, -1).mean(0), np.asarray(wm).reshape(-1) * 2 - 1)[0, 1])

    # u8 carry in both loops (an f32 carry adds ~37 MB/frame of traffic at
    # 1080p).  The wm spectrum is hoisted out of the loop like the pipeline
    # drivers do (wm_hp_device)
    ri = codec.wm_hp_device((1080, 1920), np.asarray(wm))

    @partial(jax.jit, static_argnums=2)
    def loop(x, ri, n):
        def body(i, x):
            return codec.mark_frames_hp(x, ri)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    @partial(jax.jit, static_argnums=1)
    def xloop(x, n):
        def body(i, x):
            r = codec.extract_frames(x)
            return u8_carry(x, r)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 32
    loop(frames, ri, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, ri, iters).block_until_ready()
    mark_fps = b * iters / (time.perf_counter() - t0)
    xloop(frames, iters).block_until_ready()
    t0 = time.perf_counter()
    xloop(frames, iters).block_until_ready()
    ext_fps = b * iters / (time.perf_counter() - t0)
    return {"batch": b, "mark_fps_chip": round(mark_fps, 1),
            "extract_fps_chip": round(ext_fps, 1),
            "mark_hbm_gbps": hbm_gbps(mark_fps, 1080, 1920, 2),
            "extract_hbm_gbps": hbm_gbps(ext_fps, 1080, 1920, 1),
            "extract_correlation": round(corr, 4)}


def bench_extract_1080p(quick):
    """Config 2d: pure-chip 1080p flagship extract throughput."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.wm import DwtDctSvd

    codec = DwtDctSvd()
    rng = np.random.RandomState(0)
    b = 8 if quick else 160
    frames = jnp.asarray(natural_frames(rng, b, 1080, 1920))

    # carry u8 like the embed loop (real pipelines feed u8): an f32 carry
    # with per-iter clip/cast adds ~90 MB/frame of traffic, which would
    # dominate the measurement.  The f32 mul is the
    # constant-fold barrier (int 0*x would fold and free the loop body).
    @partial(jax.jit, static_argnums=1)
    def loop(x, n):
        def body(i, x):
            bits = codec.extract_frames(x)
            return u8_carry(x, bits)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 96
    loop(frames, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, iters).block_until_ready()
    dt = time.perf_counter() - t0
    fps = b * iters / dt
    return {"batch": b, "extract_fps_chip": round(fps, 1),
            "hbm_gbps": hbm_gbps(fps, 1080, 1920, 1)}


def bench_embed_4k(quick):
    """Config 2e: pure-chip 4K (2160x3840) embed — pixel-rate scaling."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.fingerprint import payload_for_segment
    from vfp_tpu.wm import DwtDctSvd, Shuffler

    codec = DwtDctSvd()
    rng = np.random.RandomState(0)
    # u8 carry, like embed_1080p: an f32 carry adds ~150 MB/frame of
    # clip/cast traffic at 4K
    b = 2 if quick else 8
    frames = jnp.asarray(natural_frames(rng, b, 2160, 3840))
    wm = Shuffler(key=0).generate_wm(
        payload_for_segment(1, 2), codec.wm_capacity((2160, 3840, 3)))
    wm = jnp.asarray(np.asarray(wm).reshape(-1), jnp.float32)

    @partial(jax.jit, static_argnums=2)
    def loop(x, wm, n):
        def body(i, x):
            return codec.mark_frames(x, wm)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 96
    loop(frames, wm, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, wm, iters).block_until_ready()
    dt = time.perf_counter() - t0
    fps = b * iters / dt
    return {"batch": b, "embed_fps_chip": round(fps, 1),
            "gigapixels_per_sec": round(fps * 2160 * 3840 / 1e9, 2),
            "hbm_gbps": hbm_gbps(fps, 2160, 3840, 2)}


def bench_embed_8k(quick):
    """Config 2h: pure-chip 8K (4320x7680) embed — the top of the supported
    width range (8K-class widths are also covered by CPU parity tests,
    tests/test_plain_parity.py)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.fingerprint import payload_for_segment
    from vfp_tpu.wm import DwtDctSvd, Shuffler

    codec = DwtDctSvd()
    rng = np.random.RandomState(0)
    b = 1 if quick else 8
    # u8 carry (see embed_4k note)
    frames = jnp.asarray(natural_frames(rng, b, 4320, 7680))
    wm = Shuffler(key=0).generate_wm(
        payload_for_segment(1, 2), codec.wm_capacity((4320, 7680, 3)))
    wm = jnp.asarray(np.asarray(wm).reshape(-1), jnp.float32)

    @partial(jax.jit, static_argnums=2)
    def loop(x, wm, n):
        def body(i, x):
            return codec.mark_frames(x, wm)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 32
    loop(frames, wm, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, wm, iters).block_until_ready()
    dt = time.perf_counter() - t0
    fps = b * iters / dt
    return {"batch": b, "embed_fps_chip": round(fps, 1),
            "gigapixels_per_sec": round(fps * 4320 * 7680 / 1e9, 2),
            "hbm_gbps": hbm_gbps(fps, 4320, 7680, 2)}


def bench_extract_8k(quick):
    """Config 2j: pure-chip 8K (4320x7680) flagship extract — completes the
    pixel-rate scaling table (embed @8K is config 2h)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.wm import DwtDctSvd

    codec = DwtDctSvd()
    rng = np.random.RandomState(0)
    b = 1 if quick else 8
    frames = jnp.asarray(natural_frames(rng, b, 4320, 7680))

    @partial(jax.jit, static_argnums=1)
    def loop(x, n):
        def body(i, x):
            bits = codec.extract_frames(x)  # u8 carry — see extract_1080p note
            return u8_carry(x, bits)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 32
    loop(frames, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, iters).block_until_ready()
    dt = time.perf_counter() - t0
    fps = b * iters / dt
    return {"batch": b, "extract_fps_chip": round(fps, 1),
            "gigapixels_per_sec": round(fps * 4320 * 7680 / 1e9, 2),
            "hbm_gbps": hbm_gbps(fps, 4320, 7680, 1)}


def bench_extract_4k(quick):
    """Config 2i: pure-chip 4K flagship extract (the leak-trace scaling story
    rides extract throughput; embed @4K is config 2e)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.wm import DwtDctSvd

    codec = DwtDctSvd()
    rng = np.random.RandomState(0)
    b = 2 if quick else 24
    frames = jnp.asarray(natural_frames(rng, b, 2160, 3840))

    @partial(jax.jit, static_argnums=1)
    def loop(x, n):
        def body(i, x):
            bits = codec.extract_frames(x)  # u8 carry — see extract_1080p note
            return u8_carry(x, bits)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 48
    loop(frames, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, iters).block_until_ready()
    dt = time.perf_counter() - t0
    fps = b * iters / dt
    return {"batch": b, "extract_fps_chip": round(fps, 1),
            "gigapixels_per_sec": round(fps * 2160 * 3840 / 1e9, 2),
            "hbm_gbps": hbm_gbps(fps, 2160, 3840, 1)}


def bench_dtcwtimg_1080p(quick):
    """Config 2j: DT-CWT visible-image codec (DtcwtImg + BlockShuffler
    pairing) mark+extract on chip, with an image-recovery correlation
    check (reference: src/offmark/embed/dtcwt_img_encoder.py)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.wm.dtcwt_codecs import DtcwtImg

    codec = DtcwtImg()
    rng = np.random.RandomState(0)
    b = 4 if quick else 16  # shares the DtcwtKey fast paths; same B=16 sweet spot
    frames = jnp.asarray(natural_frames(rng, b, 1080, 1920))
    # real payload chain (reference: block_shuffler.py/de_block_shuffler.py):
    # a 27x48 binary image -> keyed block scramble -> +-255 signed plane;
    # recovery = de-scramble the extracted plane (batch-averaged), resize
    # back to the payload (antialias=True: the reference degenerator's
    # INTER_LINEAR final downsample point-samples the decoder's zero-lowpass
    # ringing and measures 0.31 agreement at 1080p where a true block
    # average measures ~0.89 — see DeBlockShuffler.degenerate), threshold
    # at the mean — same statistic tests/test_dtcwt.py holds to > 0.75
    from vfp_tpu.wm.payload_img import BlockShuffler, DeBlockShuffler

    cap = codec.wm_capacity((1080, 1920, 3))
    img = (rng.rand(27, 48) > 0.5).astype(np.float32) * 255
    wm = jnp.asarray(BlockShuffler(key=5).generate_wm(img, cap), jnp.float32)

    marked = codec.mark_frames(frames, wm)
    rec = np.asarray(codec.extract_frames(marked))
    mean_rec = rec.mean(0)
    corr = float(np.corrcoef(mean_rec.reshape(-1), np.asarray(wm).reshape(-1))[0, 1])
    out = DeBlockShuffler(key=5).set_shape(img.shape).degenerate(
        mean_rec, antialias=True)
    agree = float(np.mean((out > out.mean()) == (img > 127)))

    # u8 carry + hoisted wm spectrum (see bench_dtcwt_1080p note)
    ri = codec.wm_hp_device((1080, 1920), np.asarray(wm))

    @partial(jax.jit, static_argnums=2)
    def loop(x, ri, n):
        def body(i, x):
            return codec.mark_frames_hp(x, ri)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    @partial(jax.jit, static_argnums=1)
    def xloop(x, n):
        def body(i, x):
            r = codec.extract_frames(x)
            return u8_carry(x, r)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 32
    loop(frames, ri, iters).block_until_ready()
    t0 = time.perf_counter()
    loop(frames, ri, iters).block_until_ready()
    mark_fps = b * iters / (time.perf_counter() - t0)
    xloop(frames, iters).block_until_ready()
    t0 = time.perf_counter()
    xloop(frames, iters).block_until_ready()
    ext_fps = b * iters / (time.perf_counter() - t0)
    return {"batch": b, "mark_fps_chip": round(mark_fps, 1),
            "extract_fps_chip": round(ext_fps, 1),
            "mark_hbm_gbps": hbm_gbps(mark_fps, 1080, 1920, 2),
            "extract_hbm_gbps": hbm_gbps(ext_fps, 1080, 1920, 1),
            "extract_correlation": round(corr, 4),
            "correlation_note": "raw plane corr is bounded by the zero-lowpass"
            " decode, not embed strength (alpha 1.5/2.5/4.0 all measure the"
            " same clean agreement); image_agreement is the decision"
            " statistic — combined-attack floors pinned in"
            " tests/test_attacks.py::TestDtcwtImgCombinedAttackMargins",
            "image_agreement": round(agree, 4)}


def bench_dctqim_1080p(quick):
    """Config 2f: perceptual DCT-QIM codec mark+extract on chip, with a
    roundtrip bit-accuracy check."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vfp_tpu.wm import DctQim

    codec = DctQim()
    rng = np.random.RandomState(0)
    b = 4 if quick else 64
    frames = jnp.asarray(natural_frames(rng, b, 1080, 1920))
    wm = jnp.asarray(rng.randint(0, 2, codec.wm_capacity((1080, 1920, 3))), jnp.float32)
    bits = np.asarray(codec.extract_frames(codec.mark_frames(frames, wm)))
    acc = float((bits == np.asarray(wm)[None]).mean())

    # u8 carry in both loops (see bench_dtcwt_1080p note)
    @partial(jax.jit, static_argnums=2)
    def mloop(x, wm, n):
        def body(i, x):
            return codec.mark_frames(x, wm)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    @partial(jax.jit, static_argnums=1)
    def xloop(x, n):
        def body(i, x):
            r = codec.extract_frames(x)
            return u8_carry(x, r)

        return jnp.sum(jax.lax.fori_loop(0, n, body, x).astype(jnp.int32))

    iters = 2 if quick else 48
    mloop(frames, wm, iters).block_until_ready()
    t0 = time.perf_counter(); mloop(frames, wm, iters).block_until_ready()
    mark_fps = b * iters / (time.perf_counter() - t0)
    xloop(frames, iters).block_until_ready()
    t0 = time.perf_counter(); xloop(frames, iters).block_until_ready()
    ext_fps = b * iters / (time.perf_counter() - t0)
    return {"batch": b, "mark_fps_chip": round(mark_fps, 1),
            "extract_fps_chip": round(ext_fps, 1),
            "mark_hbm_gbps": hbm_gbps(mark_fps, 1080, 1920, 2),
            "extract_hbm_gbps": hbm_gbps(ext_fps, 1080, 1920, 1),
            "roundtrip_bit_accuracy": acc}


def bench_dtcwt_durability(quick):
    """Config 2c: DT-CWT keyed-plane durability through splice + lossy
    re-encode + re-segment (VERDICT r1 item 7; reference detector bar:
    src/offmark/degenerator/de_corr_shuffler.py:27 corr > 0.1, preservation
    >= 75% per tests/segment_mark_detect_hls.py:500)."""
    import tempfile

    import numpy as np

    from vfp_tpu.io import RawVideoWriter
    from vfp_tpu.workflows.durability import run_durability_corr

    rng = np.random.RandomState(3)
    nseg = 3 if quick else 6
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "src.rawv"
        with RawVideoWriter(src, 640, 360, fps=6) as w:
            for _ in range(nseg):
                w.write_batch(natural_frames(rng, b=6, h=360, w=640))
        report = run_durability_corr(src, Path(td) / "dur",
                                     segment_duration=1.0, quality=92)
    return {
        "segments": report["segment_pairs"],
        "original_avg_frequency": round(report["original_avg_frequency"], 3),
        "reencoded_avg_frequency": round(report["reencoded_avg_frequency"], 3),
        "segment_preservation_rate": report["segment_preservation_rate"],
        "passes_75pct_bar": report["is_successful"],
    }


def bench_mp4v_durability(quick):
    """Config 2g: durability through cv2's mp4v encoder (inter-frame DCT,
    4:2:0 chroma — the closest available approximation of the reference's
    libx264 yuv420p attack, reference tests/segment_mark_detect_hls.py:500)
    for all three video codecs at their mp4v-tuned strengths (strength table:
    docs/DESIGN.md; defaults 15/20 fail this channel, 45/30 pass)."""
    import tempfile

    import numpy as np

    from vfp_tpu.io import RawVideoWriter
    from vfp_tpu.wm import DctQim, DwtDctSvd
    from vfp_tpu.workflows.durability import run_durability, run_durability_corr

    rng = np.random.RandomState(7)
    nseg = 2 if quick else 4
    out = {}

    def coherent_segment(b, h, w):
        # one natural base frame + small per-frame brightness drift: real
        # video is temporally coherent, and an inter-frame coder fed i.i.d.
        # noise every frame spends its whole bit budget on residuals — a
        # pathological channel, not the reference's attack model
        base = natural_frames(rng, 1, h, w)[0].astype(np.float64)
        return np.clip(np.stack([base + i * 0.7 for i in range(b)]), 0, 255).astype(np.uint8)

    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "src.rawv"
        with RawVideoWriter(src, 640, 360, fps=6) as w:
            for _ in range(nseg):
                w.write_batch(coherent_segment(6, 360, 640))
        for name, runner in [
            ("flagship_scale45", lambda d: run_durability(
                src, d, segment_duration=1.0, batch_size=8, container="mp4",
                codec=DwtDctSvd(scales=(0.0, 45.0, 0.0)))),
            ("dctqim_alpha30", lambda d: run_durability(
                src, d, segment_duration=1.0, batch_size=8, container="mp4",
                codec=DctQim(alpha=30.0))),
            ("dtcwtkey_default", lambda d: run_durability_corr(
                src, d, segment_duration=1.0, batch_size=8, container="mp4")),
        ]:
            r = runner(Path(td) / name)
            out[name] = {
                "segment_preservation_rate": r["segment_preservation_rate"],
                "reencoded_success_rate": r["reencoded_success_rate"],
                "passes_75pct_bar": r["is_successful"],
            }
    return out


def bench_hls_workflow(quick):
    """Config 3: segment + mark 3 variants/segment + playlists + verify."""
    import numpy as np
    import shutil
    from vfp_tpu.fingerprint import mark_segments, segment_video, write_hls_playlists
    from vfp_tpu.fingerprint.marker import verify_segments
    from vfp_tpu.io import RawVideoWriter

    rng = np.random.RandomState(1)
    base = Path("bench_tmp_hls")
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir()
    t_setup0 = time.perf_counter()
    n = 36 if quick else 144  # frames @6fps -> 1s segments
    src = base / "src.rawv"
    with RawVideoWriter(src, 640, 480, fps=6) as w:
        w.write_batch(natural_frames(rng, n, 480, 640))
    t_setup = time.perf_counter() - t_setup0
    mark_stats: dict = {}
    t0 = time.perf_counter()
    segs = segment_video(src, base / "segments", 1.0)
    t_seg = time.perf_counter() - t0
    marked, payloads, copies = mark_segments(segs, base / "marked", copies=3,
                                             batch_size=8, stats=mark_stats)
    t2 = time.perf_counter()
    write_hls_playlists(marked, base / "hls", copies=3, segment_duration=1.0)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    ok = sum(r[2] for r in verify_segments(marked, batch_size=16))
    t_verify = time.perf_counter() - t1
    shutil.rmtree(base, ignore_errors=True)
    # every second of the entry's outer wall is attributed:
    # setup (synthetic source creation — not workflow) + split + mark +
    # playlists + verify + teardown; mark_stats' stage_seconds attribute the
    # mark wall internally (busy + wait buckets sum to ~wall per thread)
    return {
        "segments": len(segs),
        "variants": len(marked),
        "batch": 8,
        "marked_frames_per_sec_incl_io": round(n * 3 / wall, 2),
        "verified": f"{ok}/{len(marked)}",
        "setup_seconds": round(t_setup, 3),
        "segment_split_seconds": round(t_seg, 3),
        "playlist_seconds": round(wall - (t2 - t0), 3),
        "verify_seconds": round(t_verify, 3),
        "mark_stats": mark_stats,
    }


def _with_host_wire(fn, quick):
    """Run a workflow config over the zero-link host transport
    (wire='host', pipeline/lowlink.py): no link traffic at all."""
    import os

    prev = os.environ.get("VFP_LL_WIRE")
    os.environ["VFP_LL_WIRE"] = "host"
    try:
        return fn(quick)
    finally:
        if prev is None:
            del os.environ["VFP_LL_WIRE"]
        else:
            os.environ["VFP_LL_WIRE"] = prev


def bench_hls_workflow_host(quick):
    """Config 3b: hls_workflow over wire='host'."""
    return _with_host_wire(bench_hls_workflow, quick)


def bench_leak_trace(quick):
    """Config 4: leak splice + trace back to the fingerprint."""
    import numpy as np
    import shutil
    from vfp_tpu.fingerprint import generate_leak, mark_segments, segment_video, trace_leak
    from vfp_tpu.fingerprint.marker import write_manifests
    from vfp_tpu.io import RawVideoWriter

    rng = np.random.RandomState(2)
    base = Path("bench_tmp_leak")
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir()
    t_setup0 = time.perf_counter()
    n = 36 if quick else 96
    src = base / "src.rawv"
    with RawVideoWriter(src, 640, 480, fps=6) as w:
        w.write_batch(natural_frames(rng, n, 480, 640))
    segs = segment_video(src, base / "segments", 1.0)
    marked, payloads, copies = mark_segments(segs, base / "marked_segments", copies=3, batch_size=8)
    write_manifests(base, payloads, copies)
    t_setup = time.perf_counter() - t_setup0
    pattern = "".join(str(i % 3) for i in range(len(segs)))
    t0 = time.perf_counter()
    leaked, info = generate_leak(base / "segment_copies.json", pattern=pattern)
    result = trace_leak(leaked, base / "detection",
                        payload_file=base / "segment_payloads.json", segment_duration=1.0)
    wall = time.perf_counter() - t0
    out = {
        "segments": len(segs),
        "trace_frames_per_sec_incl_io": round(n / wall, 2),
        "fingerprint_recovered": result.fingerprint == info["pattern_string"],
        "success_rate": result.success_rate,
        "setup_seconds": round(t_setup, 3),  # source synth + mark; not traced
    }
    shutil.rmtree(base, ignore_errors=True)
    return out


def bench_leak_trace_host(quick):
    """Config 4b: leak trace over wire='host' — extraction is the trace
    hot loop, so the host wire removes every link roundtrip."""
    return _with_host_wire(bench_leak_trace, quick)


def bench_concurrent_serve(quick):
    """Config 5: concurrent marking via the HTTP service."""
    import concurrent.futures
    import shutil
    import threading
    import urllib.request
    import uuid

    import numpy as np
    from vfp_tpu.io import RawVideoWriter
    from vfp_tpu.serve.app import make_server

    rng = np.random.RandomState(3)
    base = Path("bench_tmp_serve")
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir()
    t_setup0 = time.perf_counter()
    n_streams = 2 if quick else 4
    frames_per = 24
    src = base / "src.rawv"
    with RawVideoWriter(src, 320, 240, fps=6) as w:
        w.write_batch(natural_frames(rng, frames_per, 240, 320))
    payload = src.read_bytes()
    t_setup = time.perf_counter() - t_setup0

    def upload(i):
        d = base / f"data{i}"
        srv = make_server("127.0.0.1", 0, d, num_copies=3, segment_duration=1.0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        boundary = uuid.uuid4().hex
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="file"; filename="src.rawv"\r\n\r\n').encode() + payload \
               + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/upload", body,
            {"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
        srv.shutdown()
        return out["total_variants"]

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=n_streams) as pool:
        variants = list(pool.map(upload, range(n_streams)))
    wall = time.perf_counter() - t0
    shutil.rmtree(base, ignore_errors=True)
    return {
        "streams": n_streams,
        "total_variants": sum(variants),
        "marked_frames_per_sec_incl_io": round(n_streams * frames_per * 3 / wall, 2),
        "setup_seconds": round(t_setup, 3),
    }


def bench_view_latency(quick):
    """Config 5b: per-view playlist/segment latency while an upload is
    MARKING — the reference's zero-compute-per-view property (SURVEY §3.5,
    reference api/main.py:715-810): starting a view only writes a history
    row and serves a text playlist; segment GETs are static file reads.
    Reported: median/p99 request latency idle vs under concurrent marking
    (both should be ms-scale and close to each other)."""
    import shutil
    import threading
    import urllib.request
    import uuid

    import numpy as np
    from vfp_tpu.io import RawVideoWriter
    from vfp_tpu.serve.app import make_server

    rng = np.random.RandomState(7)
    base = Path("bench_tmp_view")
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir()
    src = base / "src.rawv"
    with RawVideoWriter(src, 320, 240, fps=6) as w:
        w.write_batch(natural_frames(rng, 24, 240, 320))
    payload = src.read_bytes()

    srv = make_server("127.0.0.1", 0, base / "data", num_copies=3,
                      segment_duration=1.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]

    def post(path, body, ctype="application/json"):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", body, {"Content-Type": ctype})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    def upload():
        boundary = uuid.uuid4().hex
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="file"; filename="src.rawv"\r\n\r\n').encode() + payload \
               + f"\r\n--{boundary}--\r\n".encode()
        return post("/upload", body,
                    f"multipart/form-data; boundary={boundary}")

    upload()  # populate hls dir + mapping

    def one_view_cycle():
        """start-view + playlist GET + first segment GET; returns seconds."""
        t0 = time.perf_counter()
        out = post("/start-view", json.dumps({"username": "bench"}).encode())
        url = out["view_url"] if "view_url" in out else f"/view/{out['view_id']}"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}") as r:
            m3u8 = r.read().decode()
        seg = next(l for l in m3u8.splitlines() if l and not l.startswith("#"))
        seg = seg if seg.startswith("/") else "/hls/" + seg.rsplit("/", 1)[-1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{seg}") as r:
            r.read()
        return time.perf_counter() - t0

    n = 10 if quick else 40
    idle = sorted(one_view_cycle() for _ in range(n))

    marking = threading.Thread(target=upload)
    marking.start()
    loaded = []
    while marking.is_alive() and len(loaded) < 4 * n:
        loaded.append(one_view_cycle())
    mark_alive_samples = len(loaded)
    marking.join()
    srv.shutdown()
    shutil.rmtree(base, ignore_errors=True)
    loaded = sorted(loaded) or [float("nan")]
    pct = lambda xs, p: round(xs[min(len(xs) - 1, int(p * len(xs)))] * 1e3, 2)
    return {
        "idle_view_ms_p50": pct(idle, 0.5),
        "idle_view_ms_p99": pct(idle, 0.99),
        "marking_view_ms_p50": pct(loaded, 0.5),
        "marking_view_ms_p99": pct(loaded, 0.99),
        "samples_while_marking": mark_alive_samples,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="default", choices=["default", "cpu"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated config-name substrings to run; "
                         "existing bench_suite_report.json entries are kept")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run workflow-class configs N times; the reported "
                         "entry is the MEDIAN run (by headline fps) with a "
                         "per-run fps list attached")
    ap.add_argument("--entry-timeout", type=int, default=1800, metavar="SEC",
                    help="per-config watchdog: record an error entry and "
                         "move on if one config exceeds SEC seconds "
                         "(0 disables)")
    args = ap.parse_args()
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {json.dumps(device)}", flush=True)
    report = {"device": device}
    if args.only and Path("bench_suite_report.json").exists():
        report = json.loads(Path("bench_suite_report.json").read_text())
        report["device"] = device
    wanted = args.only.split(",") if args.only else None
    for name, fn in [
        ("roundtrip_480p", bench_roundtrip_480p),
        ("embed_1080p_chip", bench_embed_1080p),
        ("extract_1080p_chip", bench_extract_1080p),
        ("embed_4k_chip", bench_embed_4k),
        ("extract_4k_chip", bench_extract_4k),
        ("embed_8k_chip", bench_embed_8k),
        ("extract_8k_chip", bench_extract_8k),
        ("dctqim_1080p_chip", bench_dctqim_1080p),
        ("dtcwt_1080p_chip", bench_dtcwt_1080p),
        ("dtcwtimg_1080p_chip", bench_dtcwtimg_1080p),
        ("dtcwt_durability", bench_dtcwt_durability),
        ("durability_mp4v", bench_mp4v_durability),
        ("hls_workflow", bench_hls_workflow),
        ("hls_workflow_host", bench_hls_workflow_host),
        ("leak_trace", bench_leak_trace),
        ("leak_trace_host", bench_leak_trace_host),
        ("concurrent_serve", bench_concurrent_serve),
        ("serve_view_latency", bench_view_latency),
    ]:
        if wanted is not None and not any(s in name for s in wanted):
            continue
        fps_key = {"roundtrip_480p": "embed_fps_incl_io",
                   "hls_workflow": "marked_frames_per_sec_incl_io",
                   "hls_workflow_host": "marked_frames_per_sec_incl_io",
                   "leak_trace": "trace_frames_per_sec_incl_io",
                   "leak_trace_host": "trace_frames_per_sec_incl_io",
                   "concurrent_serve": "marked_frames_per_sec_incl_io"}.get(name)
        reps = args.repeat if (args.repeat > 1 and fps_key) else 1
        t0 = time.perf_counter()
        try:
            runs = []
            for _ in range(reps):
                t1 = time.perf_counter()
                if args.entry_timeout and hasattr(signal, "SIGALRM"):
                    # watchdog: a stalled config raises here instead of
                    # hanging the whole suite; the error entry is recorded
                    signal.signal(
                        signal.SIGALRM,
                        lambda s, f: (_ for _ in ()).throw(
                            TimeoutError(f"config exceeded {args.entry_timeout}s")),
                    )
                    signal.alarm(args.entry_timeout)
                try:
                    r = fn(args.quick)
                finally:
                    if hasattr(signal, "SIGALRM"):
                        signal.alarm(0)
                r["wall_seconds"] = round(time.perf_counter() - t1, 2)
                runs.append(r)
            if reps > 1:
                runs.sort(key=lambda r: r[fps_key])
            report[name] = runs[len(runs) // 2]  # median by headline fps
            if reps > 1:
                report[name]["runs_fps"] = [r[fps_key] for r in runs]
                # keep the median run's own wall_seconds intact; the total
                # across reps goes under its own key
                report[name]["repeat_total_seconds"] = round(
                    time.perf_counter() - t0, 2)
            else:
                report[name]["wall_seconds"] = round(time.perf_counter() - t0, 2)
        except Exception as e:  # pragma: no cover
            report[name] = {"error": str(e)}
        print(f"{name}: {json.dumps(report[name])}", flush=True)

    Path("bench_suite_report.json").write_text(json.dumps(report, indent=2))
    print("\nreport -> bench_suite_report.json")


if __name__ == "__main__":
    main()
