"""Shared utilities: typed config, trace logging, profiling hooks, compile cache."""

from .compile_cache import enable_compile_cache  # noqa: F401
from .config import VfpConfig  # noqa: F401
from .logging import trace  # noqa: F401
from .profiling import profile_trace, StageTimer  # noqa: F401
