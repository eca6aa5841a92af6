#!/usr/bin/env python3
"""Smoke test of vfp_tpu's main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: phases a, b, c
    python chip_smoke.py --four    # four cards: the multi-card phase only

One card, one process:

  a. device: the card's name and power limit (nvidia-smi), device_kind, JAX
     version, XLA_FLAGS, whether cv2 and ffmpeg are present, and the
     compiled memory analysis of the flagship 1080p mark step.
  b. codecs at 1080p: mark and extract with DwtDctSvd, DctQim, DtcwtKey and
     DtcwtImg at the CLI's batch size, jitted on the GPU, each compared with
     the same plain program jitted on the CPU for the first frames.  Also
     prints informative steady-state mark/extract frames/s (compile time
     apart) and the GB/s of the mandatory u8 frame traffic.
  c. workflow through ``vfp_tpu.cli.main``: a seeded synthetic 1080p30 .rawv
     clip of 6 s; ``mark`` then ``detect``; ``hls-mark --copies 3``, ``leak
     --pattern 012`` and ``trace``, which must give back the pattern.

``--four`` runs ``hls-mark --workers 4`` (one worker per card, this process
off the GPU meanwhile) against a one-worker run, then the sharded mark/detect
steps on a ('data', 'variant') = (2, 2) mesh and the width-sharded mark on
four cards, each against the same step on one card.

The last line of standard output is a JSON object ``{"ok": true, "device":
{...}}``; it is printed only when every phase passed.  Without a GPU, or
without the repository beside it, the script exits non-zero before that.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".smoke_work"  # listed in .gitignore; removed after each run
H, W = 1080, 1920
CLI_BATCH = 16  # the CLI's --batch-size default
PAYLOAD = "01100101"
H100_HBM_GBPS = 3350.0  # NVIDIA H100 SXM data sheet
# Largest u8 difference allowed between the GPU's and the CPU's marked
# pixels.  QIM codecs: FMA and summation order can move a .5 rounding, so 1.
# DT-CWT codecs: the perceptual masks are ceil()-quantized, so a mask value
# that sits on an integer in one device's float order moves by a whole
# step there, and the U delta of that block by alpha * |wm| (2 measured on
# an H100); still >= 99.9 % of pixels must be identical.
MAX_PIXEL_DIFF = {"bits": 1, "corr": 4, "img": 4}


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeError(msg)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def natural_frames(seed: int, b: int, h: int, w: int) -> np.ndarray:
    """Seeded synthetic content: 8x8-blocky random colour plus fine noise."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 221, (b, -(-h // 8), -(-w // 8), 3), dtype=np.uint8)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)[:, :h, :w]
    return f + rng.integers(0, 20, f.shape, dtype=np.uint8)


def write_clip(path: Path, h: int, w: int, fps: int, seconds: int, seed: int = 0):
    """A seeded synthetic .rawv clip: a blocky frame drifting sideways."""
    from vfp_tpu.io import RawVideoWriter

    base = natural_frames(seed, 1, h, w)[0]
    noise = np.random.default_rng(seed + 1).integers(0, 16, (8, h, w, 3), dtype=np.uint8)
    with RawVideoWriter(path, w, h, fps=fps) as wr:
        for t0 in range(0, fps * seconds, fps):
            wr.write_batch(np.stack([
                np.roll(base, 4 * t, axis=1) + noise[t % 8]
                for t in range(t0, min(t0 + fps, fps * seconds))]))


def run_cli(argv) -> str:
    """vfp_tpu.cli.main(argv) in this process; echoes and returns its stdout."""
    from vfp_tpu.cli.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main([str(a) for a in argv])
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out


# -- phase a -------------------------------------------------------------------

def phase_device(dev, batch: int = CLI_BATCH, h: int = H, w: int = W):
    import jax
    import jax.numpy as jnp

    from vfp_tpu.wm import DwtDctSvd

    print(f"[a] device_kind={dev.device_kind} platform={dev.platform} "
          f"count={len(jax.devices())} jax={jax.__version__}")
    print(f"[a] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"[a] cv2={'present' if importlib.util.find_spec('cv2') else 'absent'} "
          f"ffmpeg={'present' if shutil.which('ffmpeg') else 'absent'}")
    codec = DwtDctSvd()
    frames = jax.ShapeDtypeStruct((batch, h, w, 3), jnp.uint8,
                                  sharding=jax.sharding.SingleDeviceSharding(dev))
    wm = jax.ShapeDtypeStruct((h * w // 64,), jnp.float32,
                              sharding=jax.sharding.SingleDeviceSharding(dev))
    mem = jax.jit(codec.mark_frames).lower(frames, wm).compile().memory_analysis()
    print(f"[a] DwtDctSvd mark B={batch} {h}x{w} memory_analysis: {mem}")


# -- phase b -------------------------------------------------------------------

def _codec_cases(h: int, w: int):
    """(name, codec, wm, check-kind, helper) for every codec."""
    from vfp_tpu.fingerprint import payload_for_segment
    from vfp_tpu.wm import (BlockShuffler, CorrShuffler, DctQim, DeBlockShuffler,
                            DeCorrShuffler, DeShuffler, DtcwtImg, DtcwtKey,
                            DwtDctSvd, Shuffler)

    payload = payload_for_segment(1, 2)
    deg = DeShuffler(key=0, threshold="fixed").set_shape(payload.shape)
    img = (np.random.default_rng(5).random((27, 48)) > 0.5).astype(np.float32) * 255
    cases = []
    for name, codec in (("DwtDctSvd", DwtDctSvd()), ("DctQim", DctQim())):
        wm = np.asarray(Shuffler(key=0).generate_wm(payload, codec.wm_capacity((h, w, 3))),
                        np.float32).reshape(-1)
        cases.append((name, codec, wm, "bits", (deg, payload)))
    key = DtcwtKey()
    cases.append(("DtcwtKey", key,
                  np.asarray(CorrShuffler(key=3).generate_wm(None, key.wm_capacity((h, w, 3))),
                             np.float32), "corr", DeCorrShuffler(key=3)))
    im = DtcwtImg()
    cases.append(("DtcwtImg", im,
                  np.asarray(BlockShuffler(key=5).generate_wm(img, im.wm_capacity((h, w, 3))),
                             np.float32), "img",
                  (DeBlockShuffler(key=5).set_shape(img.shape),
                   DeBlockShuffler(key=6).set_shape(img.shape), img)))
    return cases


def _ncc(a, b) -> float:
    a = np.asarray(a, np.float64).ravel() - np.mean(a)
    b = np.asarray(b, np.float64).ravel() - np.mean(b)
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def _timed(fn, args, iters: int) -> float:
    """Seconds per call over ``iters`` enqueued calls, after the caller has
    compiled ``fn`` for these shapes."""
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters


def phase_codecs(dev, ref_dev, batch: int = CLI_BATCH, h: int = H, w: int = W,
                 n_ref: int = 2, iters: int = 10) -> dict:
    """Mark/extract every codec on ``dev``; compare the first ``n_ref`` frames
    with the same programs on ``ref_dev``.  Returns per-codec readings."""
    import jax

    frames = natural_frames(0, batch, h, w)
    readings = {}
    for name, codec, wm, kind, aux in _codec_cases(h, w):
        mark = jax.jit(codec.mark_frames)
        extract = jax.jit(codec.extract_frames)
        x = jax.device_put(frames, dev)
        wm_d = jax.device_put(wm, dev)
        t0 = time.perf_counter()
        marked = mark(x, wm_d).block_until_ready()
        compile_mark = time.perf_counter() - t0
        t0 = time.perf_counter()
        planes = extract(marked).block_until_ready()
        compile_extract = time.perf_counter() - t0
        marked_np, planes_np = np.asarray(marked), np.asarray(planes)

        with jax.default_device(ref_dev):
            ref_marked = np.asarray(mark(jax.device_put(frames[:n_ref], ref_dev),
                                         jax.device_put(wm, ref_dev)))
            ref_planes = np.asarray(extract(jax.device_put(marked_np[:n_ref], ref_dev)))

        diff = np.abs(marked_np[:n_ref].astype(np.int16) - ref_marked.astype(np.int16))
        same = float(np.mean(diff == 0))
        check(diff.max() <= MAX_PIXEL_DIFF[kind] and same >= 0.999,
              f"{name}: marked frames differ from the reference device "
              f"(max |diff| {diff.max()}, identical {same:.6f})")
        line = f"[b] {name}: marked max|diff|={diff.max()} identical={same:.6f}"
        if kind == "bits":
            deg, payload = aux
            agree = float(np.mean(planes_np[:n_ref] == ref_planes))
            check(agree >= 0.999, f"{name}: bit planes agree {agree:.6f} < 0.999")
            got = np.asarray(deg.degenerate_batch(planes_np))
            check(all(np.array_equal(p, payload) for p in got),
                  f"{name}: payload not recovered on every frame")
            line += f" bits agree={agree:.6f} payload {len(got)}/{len(got)} frames"
        elif kind == "corr":
            corr = np.asarray(aux.correlation_batch(planes_np))
            ref_corr = np.asarray(aux.correlation_batch(ref_planes))
            dc = float(np.max(np.abs(corr[:n_ref] - ref_corr)))
            check(dc <= 1e-3, f"{name}: correlations differ by {dc:.2e} > 1e-3")
            check(np.array_equal(corr[:n_ref] > aux.threshold, ref_corr > aux.threshold),
                  f"{name}: detect decision differs from the reference device")
            check(bool(np.all(corr > aux.threshold)),
                  f"{name}: watermark not detected on every frame ({corr.min():.3f})")
            line += f" corr={corr.min():.4f}..{corr.max():.4f} max|dcorr|={dc:.2e}"
        else:
            deg, wrong, img = aux
            nccs = [_ncc(deg.degenerate(p, antialias=True), img)
                    for p in (planes_np[0], ref_planes[0])]
            dn = abs(nccs[0] - nccs[1])
            check(dn <= 1e-3, f"{name}: recovered-image NCC differs by {dn:.2e} > 1e-3")
            # the keyed image must stand out from what a wrong key recovers
            base = _ncc(wrong.degenerate(planes_np[0], antialias=True), img)
            check(nccs[0] > base + 0.1,
                  f"{name}: recovered-image NCC {nccs[0]:.3f} vs wrong key {base:.3f}")
            line += f" ncc={nccs[0]:.4f} (wrong key {base:.4f}) |dncc|={dn:.2e}"
        print(line, flush=True)

        mark_s = _timed(mark, (x, wm_d), iters)
        extract_s = _timed(extract, (marked,), iters)
        frame_bytes = h * w * 3
        r = {
            "batch": batch,
            "compile_s": {"mark": compile_mark, "extract": compile_extract},
            "mark_fps": batch / mark_s,
            "extract_fps": batch / extract_s,
            "mark_gbps": 2 * frame_bytes * batch / mark_s / 1e9,
            "extract_gbps": frame_bytes * batch / extract_s / 1e9,
        }
        r["mark_share_of_3.35TBps"] = r["mark_gbps"] / H100_HBM_GBPS
        r["extract_share_of_3.35TBps"] = r["extract_gbps"] / H100_HBM_GBPS
        readings[name] = r
        print(f"[b] {name} reading: {json.dumps(r)}", flush=True)
    return readings


# -- phase c -------------------------------------------------------------------

def phase_workflow(work: Path, h: int = H, w: int = W, fps: int = 30,
                   seconds: int = 6, segment: int = 2, batch: int = CLI_BATCH):
    src = work / "src.rawv"
    write_clip(src, h, w, fps, seconds)
    run_cli(["mark", src, work / "marked.rawv", "--payload", PAYLOAD,
             "--batch-size", batch])
    out = run_cli(["detect", work / "marked.rawv", "--payload", PAYLOAD,
                   "--batch-size", batch])
    check(f"majority payload: {PAYLOAD}" in out, "detect: majority payload mismatch")
    hls = work / "hls_out"
    out = run_cli(["hls-mark", src, hls, "--copies", 3, "--segment-duration", segment,
                   "--batch-size", batch])
    check("All segments were watermarked successfully!" in out, "hls-mark: verify failed")
    run_cli(["leak", hls / "segment_copies.json", "--pattern", "012",
             "--segment-duration", segment])
    leaked = next(hls.glob("leaked_video.*"))
    out = run_cli(["trace", leaked, hls / "detection", "--payload-file",
                   hls / "segment_payloads.json", "--segment-duration", segment,
                   "--max-copies", 3])
    check("Copy fingerprint: 012" in out, "trace: fingerprint is not 012")
    print("[c] workflow: mark/detect, hls-mark -> leak 012 -> trace 012 OK", flush=True)


# -- four cards ----------------------------------------------------------------

def phase_farm(work: Path, workers: int = 4, h: int = H, w: int = W, fps: int = 30,
               seconds: int = 8, segment: int = 2, batch: int = CLI_BATCH):
    """hls-mark over ``workers`` processes (this process stays off JAX's
    devices until they finish) against a one-worker run."""
    src = work / "farm_src.rawv"
    write_clip(src, h, w, fps, seconds, seed=7)
    outs = {}
    for n in (workers, 1):
        outs[n] = work / f"farm_{n}"
        out = run_cli(["hls-mark", src, outs[n], "--copies", 3, "--segment-duration",
                       segment, "--batch-size", batch, "--workers", n])
        check("All segments were watermarked successfully!" in out,
              f"hls-mark --workers {n}: verify failed")
    for name in ("segment_payloads.json",):
        a = json.loads((outs[workers] / name).read_text())
        b = json.loads((outs[1] / name).read_text())
        check(a == b, f"farm: {name} differs between {workers} workers and 1")
    for n in (workers, 1):
        check(not (outs[n] / "failed_segments.json").exists(),
              f"farm: {n}-worker run has failed segments")
    files = sorted(p.name for p in (outs[1] / "marked_segments").iterdir())
    same = sum((outs[workers] / "marked_segments" / f).read_bytes()
               == (outs[1] / "marked_segments" / f).read_bytes() for f in files)
    print(f"[4] farm: {workers} workers == 1 worker (segment_payloads.json, verify); "
          f"byte-identical marked segments {same}/{len(files)}", flush=True)


def _assert_partition(arr, ndev: int, label: str) -> int:
    """The array is a true 1/ndev partition: equal per-device shards on
    ndev distinct devices whose sizes sum to the global size."""
    shards = arr.addressable_shards
    check(len({s.device for s in shards}) == ndev, f"{label}: not on {ndev} devices")
    shapes = {tuple(s.data.shape) for s in shards}
    check(len(shapes) == 1, f"{label}: unequal shards {shapes}")
    per_dev = int(np.prod(next(iter(shapes))))
    check(per_dev * ndev == int(np.prod(arr.shape)), f"{label}: replicated, not sharded")
    return per_dev


def _same_u8(got, want, label: str):
    diff = np.abs(np.asarray(got).astype(np.int16) - np.asarray(want).astype(np.int16))
    same = float(np.mean(diff == 0))
    check(diff.max() <= 1 and same >= 0.999,
          f"{label}: max |diff| {diff.max()}, identical {same:.6f}")
    return same


def phase_sharded(devices, batch: int = CLI_BATCH, h: int = H, w: int = W):
    """Sharded steps on a (2, 2) mesh and width-sharded marking on all
    devices, each against the same step on devices[0] alone."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vfp_tpu.fingerprint import payload_for_segment
    from vfp_tpu.parallel import make_mesh, sharded_detect_step, sharded_mark_step
    from vfp_tpu.parallel.sharded import shard_batch, sharded_mark_spatial
    from vfp_tpu.wm import (CorrShuffler, DctQim, DeShuffler, DtcwtKey, DwtDctSvd,
                            Shuffler)

    n = len(devices)
    check(n == 4, f"the sharded phase needs 4 devices, got {n}")
    one = devices[0]
    mesh = make_mesh(data=2, variant=2, devices=devices)
    frames = natural_frames(3, batch, h, w)
    x = shard_batch(mesh, jnp.asarray(frames))
    x1 = jax.device_put(frames, one)

    codec = DwtDctSvd()
    cap = codec.wm_capacity((h, w, 3))
    wms = np.stack([np.asarray(Shuffler(key=0).generate_wm(payload_for_segment(1, c), cap),
                               np.float32).reshape(-1) for c in range(2)])
    cases = [("DwtDctSvd", codec, wms)]
    qim = DctQim()
    qcap = qim.wm_capacity((h, w, 3))
    cases.append(("DctQim", qim, np.random.default_rng(9).integers(
        0, 2, (2, qcap[0] * qcap[1])).astype(np.float32)))
    key = DtcwtKey()
    cases.append(("DtcwtKey", key, np.stack([
        np.asarray(CorrShuffler(key=3 + c).generate_wm(None, key.wm_capacity((h, w, 3))),
                   np.float32).reshape(-1) for c in range(2)])))
    marked_flag = None
    for name, c, wm in cases:
        marked = sharded_mark_step(mesh, c)(x, jnp.asarray(wm)).block_until_ready()
        check(marked.shape == (2, batch, h, w, 3), f"{name}: shape {marked.shape}")
        per_dev = _assert_partition(marked, n, f"{name} sharded mark")
        mark1 = jax.jit(c.mark_frames)
        for v in range(2):
            same = _same_u8(marked[v], mark1(x1, jax.device_put(wm[v], one)),
                            f"{name} variant {v} sharded vs one card")
        print(f"[4] {name}: sharded mark (2x2 mesh) == one card, identical {same:.6f}, "
              f"{per_dev} elements per device", flush=True)
        if name == "DwtDctSvd":
            marked_flag = marked

    payload = payload_for_segment(1, 1)
    deg = DeShuffler(key=0, threshold="fixed").set_shape(payload.shape)
    cands = jnp.asarray(np.stack([payload_for_segment(1, c) for c in range(3)]), jnp.float32)
    votes = np.asarray(sharded_detect_step(mesh, codec, deg, 3)(
        shard_batch(mesh, marked_flag[1]), cands))
    bits1 = jax.jit(codec.extract_frames)(jax.device_put(np.asarray(marked_flag[1]), one))
    pay1 = np.asarray(deg.degenerate_batch(bits1)).astype(np.int32)
    votes1 = np.array([int(np.all(pay1 == np.asarray(cands[c], np.int32), axis=1).sum())
                       for c in range(3)])
    check(np.array_equal(votes, votes1) and votes[1] == batch,
          f"sharded detect votes {votes.tolist()} vs one card {votes1.tolist()}")
    print(f"[4] sharded detect votes {votes.tolist()} == one card", flush=True)

    dp_mesh = make_mesh(data=n, variant=1, devices=devices)
    nbh, nbw = (h // 2) // 4, (w // 2) // 4
    wm2d = jnp.asarray(wms[0][: nbh * nbw].reshape(nbh, nbw))
    xs = jax.device_put(jnp.asarray(frames), NamedSharding(dp_mesh, P(None, None, "data", None)))
    spatial = sharded_mark_spatial(dp_mesh, codec, w)(xs, wm2d).block_until_ready()
    per_dev = _assert_partition(spatial, n, "spatial mark")
    same = _same_u8(spatial, jax.jit(codec.mark_frames)(x1, jax.device_put(wms[0], one)),
                    "width-sharded mark vs one card")
    print(f"[4] width-sharded mark over {n} devices == one card, identical {same:.6f}, "
          f"{per_dev} elements per device", flush=True)


# -- driver --------------------------------------------------------------------

def _gpu_devices(count: int):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: JAX found {devs[0].platform} devices")
    check(len(devs) >= count, f"needs {count} GPU(s), JAX found {len(devs)}")
    return devs


def _fresh_work() -> Path:
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    return WORK


def run_one():
    devs = _gpu_devices(1)
    import jax

    phase_device(devs[0])
    phase_codecs(devs[0], jax.devices("cpu")[0])
    try:
        phase_workflow(_fresh_work())
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return devs


def run_four():
    from vfp_tpu.parallel.farm import visible_cards

    # the farm's workers take the cards; JAX stays off them here till then
    check(len(visible_cards()) >= 4, "--four needs 4 visible GPUs")
    try:
        phase_farm(_fresh_work())
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    devs = _gpu_devices(4)
    phase_sharded(devs[:4])
    return devs[:4]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (farm + sharded steps)")
    args = ap.parse_args(argv)
    # the CLI's per-frame INFO lines would bury the phase results
    logging.basicConfig(level=logging.WARNING)
    sys.path.insert(0, str(REPO))
    from vfp_tpu.utils import enable_compile_cache

    enable_compile_cache()
    devs = run_four() if args.four else run_one()
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                             "kind": devs[0].device_kind,
                                             "count": len(devs)}}))


if __name__ == "__main__":
    main()
