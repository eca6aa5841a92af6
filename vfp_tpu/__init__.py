"""vfp_tpu — forensic video watermarking & HLS fingerprinting in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference
``vikasdimaniya/video-fingerprinting`` ("offmark-py") framework: invisible
per-frame frequency-domain watermark codecs, keyed payload spread/recovery,
batched video pipelines, HLS per-segment fingerprinting, leak simulation and
leak tracing, and a serving layer.

Design: frames are a batch axis (``[B, H, W, C]`` tensors), every codec is a
pure jittable function, parallelism is expressed with ``jax.sharding`` over a
device mesh, and XLA compiles each codec's embed/extract path for the
device (an NVIDIA GPU, or the CPU for tests).
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy convenience exports (keep `import vfp_tpu` light)."""
    from importlib import import_module

    codecs = {"DwtDctSvd", "DctQim", "DtcwtKey", "DtcwtImg",
              "Shuffler", "DeShuffler", "GrayScale", "DeGrayScale",
              "CorrShuffler", "DeCorrShuffler", "BlockShuffler", "DeBlockShuffler"}
    if name in codecs:
        return getattr(import_module(".wm", __name__), name)
    if name in {"Embedder", "Extractor", "FrameMarker", "FrameExtractor", "MultiMarker"}:
        return getattr(import_module(".pipeline", __name__), name)
    if name in {"VfpConfig"}:
        return getattr(import_module(".utils", __name__), name)
    raise AttributeError(name)
