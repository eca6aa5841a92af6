"""Benchmark: flagship 1080p mark throughput on one device vs the reference CPU path.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"compile_seconds"}.  The device time is a steady window of jitted calls
ending in ``block_until_ready``, after a warm-up call that compiles.

Baseline protocol (BASELINE.md): the reference publishes no numbers, so the
baseline is the *measured* per-frame CPU implementation of the reference
algorithm (per-block cv2.dct + np.linalg.svd loop — tests/oracle.py is that
implementation).  Measured once and cached in BENCH_BASELINE.json because it
runs at seconds per 1080p frame.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from vfp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

H, W = 1080, 1920
BASELINE_FILE = REPO / "BENCH_BASELINE.json"


def natural_frames(rng, b, h, w):
    small = rng.rand(b, h // 8, w // 8, 3)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2) * 220 + rng.rand(b, h, w, 3) * 20
    return np.clip(f, 0, 255).astype(np.uint8)


def measure_cpu_baseline() -> float:
    """Reference-equivalent CPU embed fps at 1080p (per-block LAPACK loop)."""
    import oracle
    from vfp_tpu.wm import Shuffler
    from vfp_tpu.fingerprint import payload_for_segment

    rng = np.random.RandomState(0)
    frame = natural_frames(rng, 1, H, W)[0]
    wm = Shuffler(key=0).generate_wm(payload_for_segment(1, 2), (1, H * W // 64))
    wm = np.asarray(wm).flatten().astype(np.float64)
    t0 = time.perf_counter()
    oracle.mark_frame_u8(frame, wm)
    dt = time.perf_counter() - t0
    return 1.0 / dt


def measure_device(batch: int = 128, iters: int = 20):
    """(steady-state mark fps, compile seconds) for the flagship at 1080p."""
    import jax
    import jax.numpy as jnp

    from vfp_tpu.wm import DwtDctSvd, Shuffler
    from vfp_tpu.fingerprint import payload_for_segment

    codec = DwtDctSvd()
    rng = np.random.RandomState(0)
    frames = jnp.asarray(natural_frames(rng, batch, H, W))
    wm = Shuffler(key=0).generate_wm(payload_for_segment(1, 2), codec.wm_capacity((H, W, 3)))
    wm = jnp.asarray(np.asarray(wm).reshape(-1), jnp.float32)
    fn = jax.jit(codec.mark_frames)

    t0 = time.perf_counter()
    fn(frames, wm).block_until_ready()  # compile + warm
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(frames, wm)
    out.block_until_ready()
    return batch * iters / (time.perf_counter() - t0), compile_s


def main():
    if BASELINE_FILE.exists():
        cpu_fps = json.loads(BASELINE_FILE.read_text())["embed_1080p_fps_cpu"]
    else:
        cpu_fps = measure_cpu_baseline()
        BASELINE_FILE.write_text(
            json.dumps(
                {
                    "embed_1080p_fps_cpu": cpu_fps,
                    "note": "reference-equivalent per-frame CPU loop (tests/oracle.py), measured on the host CPU",
                },
                indent=2,
            )
        )

    import jax

    dev = jax.devices()[0]
    fps, compile_s = measure_device()
    print(
        json.dumps(
            {
                "metric": "embed_1080p_fps_per_device",
                "value": fps,
                "unit": "frames/s",
                "vs_baseline": fps / cpu_fps,
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "compile_seconds": compile_s,
            }
        )
    )


if __name__ == "__main__":
    main()
