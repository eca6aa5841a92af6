"""Host pipeline drivers: overlap video I/O with batched device compute."""

from .embedder import Embedder, FrameMarker, MultiMarker, use_lowlink  # noqa: F401
from .extractor import (  # noqa: F401
    ExtractResult,
    Extractor,
    FrameExtractor,
    cached_bit_extractor,
)
from .lowlink import LowLinkExtractor, LowLinkMarker, host_ll, reconstruct  # noqa: F401
