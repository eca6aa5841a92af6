"""One typed configuration consumed by library, CLI, and service.

The reference scatters its knobs across constructor defaults and argparse
flags (reference: dwt_dct_svd_encoder.py:6 scales/blk, dct_encoder.py:6
alpha, dtcwt_key_encoder.py:7 str/step, mark_video_to_hls.py:297-307,
api/main.py:287 num_copies, thresholds at mark_video_to_hls.py:381,
de_corr_shuffler.py:27, segment_mark_detect_hls.py:500).  This collects them
with the same defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict


@dataclass
class CodecConfig:
    # DwtDctSvd
    scales: tuple = (0.0, 15.0, 0.0)
    blk: int = 4
    # DctQim
    alpha_dct: float = 20.0
    # Dtcwt
    alpha_key: float = 10.0
    alpha_img: float = 1.5
    step: float = 5.0


@dataclass
class WorkflowConfig:
    segment_duration: float = 2.0
    copies: int = 3
    key: int = 0
    batch_size: int = 16
    quality: int = 95
    verify_threshold: float = 0.5  # majority frequency bar per segment
    preservation_threshold: float = 0.75  # durability pass bar
    correlation_threshold: float = 0.1  # spread-spectrum presence


@dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    data_dir: str = "serve_data"


@dataclass
class VfpConfig:
    codec: CodecConfig = field(default_factory=CodecConfig)
    workflow: WorkflowConfig = field(default_factory=WorkflowConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VfpConfig":
        return cls(
            codec=CodecConfig(**d.get("codec", {})),
            workflow=WorkflowConfig(**d.get("workflow", {})),
            serve=ServeConfig(**d.get("serve", {})),
        )

    @classmethod
    def load(cls, path) -> "VfpConfig":
        import json

        with open(path) as f:
            return cls.from_dict(json.load(f))

    def make_codec(self, name: str):
        """Codec factory: 'dwtDctSvd' | 'dct' | 'dtcwtKey' | 'dtcwtImg'."""
        from ..wm import DctQim, DtcwtImg, DtcwtKey, DwtDctSvd

        c = self.codec
        name = name.lower()
        if name in ("dwtdctsvd", "dwt_dct_svd", "svd"):
            return DwtDctSvd(scales=tuple(c.scales), blk=c.blk)
        if name in ("dct", "dctqim", "dct_qim"):
            return DctQim(alpha=c.alpha_dct)
        if name in ("dtcwtkey", "dtcwt_key"):
            return DtcwtKey(alpha=c.alpha_key, step=c.step)
        if name in ("dtcwtimg", "dtcwt_img"):
            return DtcwtImg(alpha=c.alpha_img, step=c.step)
        raise ValueError(f"unknown codec: {name}")
