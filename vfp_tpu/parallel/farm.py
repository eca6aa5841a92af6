"""Segment farm: scale HLS marking across processes / hosts.

Segments are embarrassingly parallel (every frame carries the full payload;
outputs are per-segment files + mergeable JSON manifests), so the scaling
model is a work queue, not collectives (SURVEY.md §2.5):

* single host, many cores/chips: ``mark_segments_parallel`` forks worker
  processes, each taking a contiguous slice of segments (each worker keeps
  the one-decode-for-all-copies property and its own jit cache).
* many hosts: ``mark_segments_distributed`` — ``jax.distributed`` rank
  sharding over a shared filesystem.  Each process marks its contiguous
  slice, writes a per-rank manifest shard, and rank 0 merges after a
  cross-host barrier.  (Running one ``vfp_tpu.cli hls-mark --resume`` per
  host works too: per-segment outputs are idempotent.)

Workers run on the parent's JAX platform.  On a GPU, worker *i* sees
exactly one card (``CUDA_VISIBLE_DEVICES``), there are never more workers
than cards, and the parent must not touch the GPU until the workers are done:
a JAX process reserves most of a card's memory when it first uses it, so a
second process on the same card fails for want of memory.
"""

from __future__ import annotations

import multiprocessing
import os
import subprocess
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

_GPU_PLATFORMS = ("cuda", "gpu")


def _slice(n_items: int, n_workers: int, rank: int):
    per = -(-n_items // n_workers)
    return rank * per, min((rank + 1) * per, n_items)


def visible_cards() -> list[str]:
    """CUDA device ids this process may use, found without initializing a
    JAX backend: ``CUDA_VISIBLE_DEVICES`` if set, else ``nvidia-smi``'s list
    (empty when there is no driver)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def parent_platform() -> str:
    """The JAX platform this process is configured for, read without
    initializing a backend: the first entry of ``jax_platforms`` if set,
    else 'cuda' when a card is visible (JAX's own default), else 'cpu'."""
    import jax

    configured = (jax.config.jax_platforms or "").split(",")[0].strip()
    if configured:
        return configured
    return "cuda" if visible_cards() else "cpu"


def worker_envs(workers: int, platform: str, cards: list[str]) -> list[dict]:
    """Per-rank environment of the farm's workers: the parent's platform and,
    on a GPU, one card each."""
    if platform not in _GPU_PLATFORMS:
        return [{"JAX_PLATFORMS": platform} for _ in range(workers)]
    if workers > len(cards):
        raise ValueError(
            f"{workers} workers but {len(cards)} visible GPU(s): a farm runs "
            "one worker per card")
    return [{"JAX_PLATFORMS": platform, "CUDA_VISIBLE_DEVICES": cards[i]}
            for i in range(workers)]


def _worker(args):
    (segments, marked_dir, copies, key, batch_size, quality, out_ext,
     first_number, env) = args
    # before any backend use: jax may already be imported (the package
    # imports it), so the platform goes through jax.config as well
    os.environ.update(env)
    import jax

    jax.config.update("jax_platforms", env["JAX_PLATFORMS"])
    from ..fingerprint.marker import mark_segments

    marked, payloads, copies_info = mark_segments(
        segments, marked_dir, copies=copies, key=key, batch_size=batch_size,
        quality=quality, out_ext=out_ext, resume=True,
        first_segment_number=first_number,
    )
    return (
        [(m.file, m.segment_number, m.copy_index, m.payload) for m in marked],
        payloads,
        copies_info["segments"],
    )


def mark_segments_parallel(
    segments,
    marked_dir,
    copies: int = 1,
    key: int = 0,
    workers: int = 2,
    batch_size: int = 16,
    quality: int = 95,
    out_ext: str | None = None,
):
    """Fan the segment x copies work queue over worker processes, one
    process per rank (and, on a GPU, one card per process).

    Returns (marked, segment_payloads, segment_copies) with the same shapes
    as fingerprint.marker.mark_segments.
    """
    from ..fingerprint.marker import MarkedSegment

    platform = parent_platform()
    envs = worker_envs(workers, platform,
                       visible_cards() if platform in _GPU_PLATFORMS else [])
    segments = [str(s) for s in segments]
    marked_dir = Path(marked_dir)
    marked_dir.mkdir(parents=True, exist_ok=True)
    tasks = []
    for rank in range(workers):
        lo, hi = _slice(len(segments), workers, rank)
        if lo >= hi:
            continue
        tasks.append((segments[lo:hi], str(marked_dir), copies, key, batch_size,
                      quality, out_ext, lo, envs[rank]))
    marked: list = []
    payloads: dict = {}
    seg_entries: dict = {}
    # spawn: forking a JAX-initialized parent deadlocks.  One single-process
    # pool per rank, so no process ever runs two ranks (and two cards' envs)
    ctx = multiprocessing.get_context("spawn")
    pools = [ProcessPoolExecutor(max_workers=1, mp_context=ctx) for _ in tasks]
    try:
        futures = [pool.submit(_worker, t) for pool, t in zip(pools, tasks)]
        for fut in futures:
            m_list, p, entries = fut.result()
            marked.extend(MarkedSegment(*m) for m in m_list)
            payloads.update(p)
            seg_entries.update(entries)
    finally:
        for pool in pools:
            pool.shutdown()
    marked.sort(key=lambda m: (m.segment_number, m.copy_index))
    segment_copies = {
        "segments": seg_entries,
        "total_segments": len(segments),
        "copies_per_segment": copies,
        "total_marked_segments": len(marked),
    }
    return marked, payloads, segment_copies


def merge_manifest_shards(shard_dir, world: int | None = None) -> tuple[list, dict, dict]:
    """Merge per-rank manifest shards (``manifest_rank*.json``) into the
    (marked, segment_payloads, segment_copies) triple of mark_segments.

    ``world`` bounds the ranks considered: a resume with a smaller world size
    leaves stale higher-rank shards from the previous run on disk, and merging
    those would double-count segments."""
    import json

    from ..fingerprint.marker import MarkedSegment

    marked: list = []
    payloads: dict = {}
    seg_entries: dict = {}
    total_segments = 0
    copies = 1
    for f in sorted(Path(shard_dir).glob("manifest_rank*.json")):
        try:
            rank = int(f.stem.removeprefix("manifest_rank"))
        except ValueError:
            continue
        if world is not None and rank >= world:
            continue
        shard = json.loads(f.read_text())
        marked.extend(MarkedSegment(*m) for m in shard["marked"])
        payloads.update(shard["payloads"])
        seg_entries.update(shard["segments"])
        total_segments += shard["n_segments"]
        copies = shard["copies"]
    marked.sort(key=lambda m: (m.segment_number, m.copy_index))
    segment_copies = {
        "segments": seg_entries,
        "total_segments": total_segments,
        "copies_per_segment": copies,
        "total_marked_segments": len(marked),
    }
    return marked, payloads, segment_copies


def mark_segments_distributed(
    segments,
    marked_dir,
    copies: int = 1,
    key: int = 0,
    batch_size: int = 16,
    quality: int = 95,
    out_ext: str | None = None,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Multi-host segment farm over ``jax.distributed`` + a shared filesystem.

    Every participating process calls this with the same arguments
    (``marked_dir`` on a filesystem all hosts see).  Process ``i`` of ``N``
    marks segments [ceil(S/N)*i, ceil(S/N)*(i+1)) — the same contiguous
    ``_slice`` as the process farm — writes ``manifest_rank{i}.json``, and
    after a global barrier rank 0 merges the shards and returns the full
    (marked, payloads, segment_copies) triple; other ranks return their own
    shard's triple.  Initialization follows jax.distributed semantics: with
    no explicit arguments, cluster-autodetect / env vars apply; single
    process (num_processes=1) needs no coordinator and is how the unit test
    runs this path.
    """
    import json

    import jax

    # init only when not already initialized (re-init raises RuntimeError).
    # Probe via is_initialized(), NOT jax.process_count(): the latter
    # initializes the local backend, after which distributed.initialize can
    # no longer take effect
    if not jax.distributed.is_initialized() and (
        coordinator_address or (num_processes or 1) > 1
    ):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    rank, world = jax.process_index(), jax.process_count()
    segments = [str(s) for s in segments]
    marked_dir = Path(marked_dir)
    marked_dir.mkdir(parents=True, exist_ok=True)
    lo, hi = _slice(len(segments), world, rank)

    from ..fingerprint.marker import mark_segments

    marked, payloads, copies_info = mark_segments(
        segments[lo:hi], marked_dir, copies=copies, key=key,
        batch_size=batch_size, quality=quality, out_ext=out_ext, resume=True,
        first_segment_number=lo,
    )
    shard = {
        "marked": [[m.file, m.segment_number, m.copy_index, m.payload] for m in marked],
        "payloads": payloads,
        "segments": copies_info["segments"],
        "n_segments": hi - lo,
        "copies": copies,
    }
    (marked_dir / f"manifest_rank{rank}.json").write_text(json.dumps(shard))

    if world > 1:  # cross-host barrier before the merge reads all shards
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("vfp_farm_shards")
    if rank == 0:
        return merge_manifest_shards(marked_dir, world=world)
    return marked, payloads, copies_info
