"""Compile + load the vfpio shared library (ctypes)."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "vfpio.cpp"
_BUILD = Path(__file__).parent / "build"


def _compile_flags() -> list[str]:
    # -mf16c/-mavx2 (x86 only): _Float16 (host-LL f16 output) needs F16C;
    # -ffp-contract=off: no FMA fusion, so float association matches the
    # NumPy/cv2 reference paths as closely as the source order implies
    arch_flags = (["-mf16c", "-mavx2"]
                  if platform.machine() in ("x86_64", "AMD64", "i686") else [])
    return ["-O3", *arch_flags, "-ffp-contract=off", "-shared", "-fPIC",
            "-std=c++17", "-pthread"]


def library_path() -> Path:
    """The library built from this exact vfpio.cpp with these flags: the
    name carries a hash of both, so a library copied in with a checkout is
    only ever reused for the source and flags it was built from."""
    key = hashlib.sha256(
        _SRC.read_bytes() + "\0".join(_compile_flags()).encode()).hexdigest()[:16]
    return _BUILD / f"libvfpio-{key}.so"


def have_native() -> bool:
    return shutil.which("g++") is not None or library_path().exists()


_LOAD_ERROR: list = []  # lru_cache does not cache exceptions; a failed
# build/load must not re-spawn g++ on every hot-path call (host_ll /
# reconstruct fall back per call), so remember the first failure here


@lru_cache(maxsize=1)
def load_vfpio():
    """Build (if needed) and load libvfpio; returns configured ctypes CDLL.

    Raises RuntimeError when no compiler and no prebuilt library exist.
    Failures are sticky: the first error is re-raised on later calls
    without retrying the compile.
    """
    if _LOAD_ERROR:
        raise _LOAD_ERROR[0]
    try:
        return _load_vfpio_uncached()
    except Exception as e:
        _LOAD_ERROR.append(RuntimeError(f"vfpio build/load failed: {e}"))
        raise _LOAD_ERROR[0] from e


def _load_vfpio_uncached():
    so = library_path()
    if not so.exists():
        if shutil.which("g++") is None:
            raise RuntimeError(f"no g++ and no prebuilt {so.name}")
        _BUILD.mkdir(exist_ok=True)
        # build under a private name, then rename: concurrent processes
        # (test workers, farm workers) never load a half-written library
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *_compile_flags(), str(_SRC), "-o", str(tmp)]
        logger.info("building vfpio: %s", " ".join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    lib.vfpio_reader_open_file.restype = ctypes.c_void_p
    lib.vfpio_reader_open_file.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_long]
    lib.vfpio_reader_open_cmd.restype = ctypes.c_void_p
    lib.vfpio_reader_open_cmd.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
    lib.vfpio_read_batch.restype = ctypes.c_long
    lib.vfpio_read_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.vfpio_reader_close.argtypes = [ctypes.c_void_p]
    lib.vfpio_writer_open_file.restype = ctypes.c_void_p
    lib.vfpio_writer_open_file.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
    lib.vfpio_writer_open_cmd.restype = ctypes.c_void_p
    lib.vfpio_writer_open_cmd.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
    lib.vfpio_write_batch.restype = ctypes.c_long
    lib.vfpio_write_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.vfpio_writer_close.restype = ctypes.c_int
    lib.vfpio_writer_close.argtypes = [ctypes.c_void_p]
    lib.vfpio_host_ll.restype = None
    lib.vfpio_host_ll.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ]
    lib.vfpio_qim_dll.restype = None
    lib.vfpio_qim_dll.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_float,
    ]
    lib.vfpio_qim_bits.restype = None
    lib.vfpio_qim_bits.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_float,
    ]
    try:  # absent from older prebuilt .so files (no g++ to rebuild):
        # callers hasattr-gate on it, so a missing symbol must not poison
        # the loader for the symbols that DO exist
        lib.vfpio_recentre2.restype = None
        lib.vfpio_recentre2.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.vfpio_qim_repair.restype = None
        lib.vfpio_qim_repair.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_float,
        ]
    except AttributeError:  # pragma: no cover - depends on .so vintage
        pass
    lib.vfpio_reconstruct.restype = None
    lib.vfpio_reconstruct.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long,
    ]
    return lib
