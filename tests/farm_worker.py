"""Rank worker for the 2-process ``jax.distributed`` farm test.

Launched as ``python farm_worker.py '<json config>'`` by
tests/test_parallel.py::TestSegmentFarm::test_distributed_two_processes.
Each rank marks its contiguous segment slice via
``mark_segments_distributed``; rank 0 additionally dumps the merged triple
so the parent test can compare it against a serial run.

Kept out of the test module itself so the subprocess imports no pytest
machinery and controls its own JAX platform before first backend use.
"""

import json
import sys
from pathlib import Path


def main():
    cfg = json.loads(sys.argv[1])
    sys.path.insert(0, cfg["repo"])
    import jax

    # CPU before ANY backend use; distributed init happens inside the farm call
    jax.config.update("jax_platforms", "cpu")

    from vfp_tpu.parallel.farm import mark_segments_distributed

    marked, payloads, copies = mark_segments_distributed(
        cfg["segments"],
        cfg["marked_dir"],
        copies=cfg["copies"],
        batch_size=8,
        coordinator_address=cfg["coordinator"],
        num_processes=cfg["nproc"],
        process_id=cfg["pid"],
    )
    if jax.process_index() == 0:
        Path(cfg["out"]).write_text(
            json.dumps(
                {
                    "marked": [
                        [m.file, m.segment_number, m.copy_index, m.payload] for m in marked
                    ],
                    "payloads": payloads,
                    "copies": copies,
                }
            )
        )


if __name__ == "__main__":
    main()
