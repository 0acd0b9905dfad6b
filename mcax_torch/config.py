"""Config system + the 5 acceptance presets — the port's copy of
``mcax/config.py`` (numpy and the standard library only).

The reference exposes parameters as C++ constructor arguments (sample rate,
FFT order, mic distances/geometry, thresholds) plus CMake build options; mcax
centralises them in frozen dataclasses so every parity-sensitive knob
(SURVEY.md §7.4: window shape, PHAT eps, frame advance, lag clamping,
covariance lambda/delta, ...) lives in one visible place and flows into the
block step as static structure.

Presets mirror BASELINE.json:6-12 exactly:
  config1  2-mic GCC-PHAT TDOA, 16 kHz stereo, 512-pt frames
  config2  4-mic linear delay-sum, fixed steering, 16 kHz, OLA output
  config3  8-mic circular SRP-PHAT, 360x1deg grid, single static source
  config4  8-mic MVDR, recursive covariance + diagonal loading, 48 kHz
  config5  16-mic, 2 moving sources: SRP tracking + per-source MVDR
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

import numpy as np

from mcax_torch import geometry as geo


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    kind: str = "linear"              # linear | circular | custom
    num_mics: int = 2
    spacing: float = 0.1              # linear: metres between mics
    radius: float = 0.05              # circular: metres
    positions: Optional[Tuple[Tuple[float, ...], ...]] = None   # custom
    speed_of_sound: float = geo.SPEED_OF_SOUND

    def geometry(self, sample_rate: float) -> geo.ArrayGeometry:
        if self.kind == "linear":
            pos = geo.linear_positions(self.num_mics, self.spacing)
        elif self.kind == "circular":
            pos = geo.circular_positions(self.num_mics, self.radius)
        elif self.kind == "custom":
            pos = np.asarray(self.positions, dtype=np.float64)
        else:
            raise ValueError(f"unknown array kind {self.kind!r}")
        return geo.ArrayGeometry(positions=pos, sample_rate=sample_rate,
                                 speed_of_sound=self.speed_of_sound)


@dataclasses.dataclass(frozen=True)
class StftConfig:
    frame_len: int = 512
    hop: int = 256                    # frame advance; default 50% overlap
    synthesis: bool = False           # True → WOLA sqrt-hann pair + OLA output

    @property
    def num_bins(self) -> int:
        return self.frame_len // 2 + 1


# The eight algos and what each needs besides the analysis: the one table of
# facts about them (``AlgoConfig.needs``; ``mcax_torch/chain.py`` orders the
# stages).  "gcc", "srp": the GCC or SRP plan; "fixed": the steering vector
# at ``steer_azimuth_rad``; "mask": the mask's expected phases; "tracker":
# config5's tracker and its state; "covariance": the covariance state (the
# MVDR family); "synthesis": the synthesis window and the OLA tail (audio
# out).
ALGOS = {
    "gcc": frozenset({"gcc"}),
    "delaysum": frozenset({"fixed", "synthesis"}),
    "srp": frozenset({"srp"}),
    "srp_delaysum": frozenset({"srp", "synthesis"}),
    "mvdr": frozenset({"fixed", "covariance", "synthesis"}),
    "srp_mvdr": frozenset({"srp", "covariance", "synthesis"}),
    "track_mvdr": frozenset({"srp", "tracker", "covariance", "synthesis"}),
    "mask": frozenset({"mask", "synthesis"}),
}


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    name: str = "gcc"                 # one of ALGOS
    phat_eps: float = 1e-12
    gcc_weighting: str = "phat"       # phat|scot|roth|cc (Knapp-Carter family)
    interpolate: bool = True          # parabolic fractional-lag peak
    srp_interpolate: bool = False     # parabolic sub-grid DOA refinement
    # Sub-band processing (dspone SubBandSTFT analogue): restrict GCC/SRP to
    # a frequency band [lo, hi] Hz; None = full band.
    band_hz: Optional[Tuple[float, float]] = None
    # Multiband GCC (mcarray's multiband binaural localisation analogue):
    # split the spectrum into this many mel-spaced sub-bands, estimate
    # per-band TDOAs independently and fuse by coherence (gcc algo only).
    gcc_bands: Optional[int] = None
    # SRP grid
    grid_points: int = 360
    # Fixed steering (delay-sum / MVDR without localisation), radians.
    # SRP-steered variants are algo names: srp_delaysum / srp_mvdr.
    steer_azimuth_rad: float = 0.0
    # Covariance recursion (C8) / MVDR (C9)
    cov_forget: float = 0.95          # lambda
    diag_load: float = 1e-3           # delta (times tr(R)/C)
    # Tracking (C11)
    num_sources: int = 2
    peak_suppression_deg: float = 20.0
    track_smooth: float = 0.7         # EMA smoothing on tracked angles
    # Track smoother: "ema" (greedy associate + EMA) or "particle" (the
    # dspone ParticleFilter analogue smoothing localisation in-loop,
    # SURVEY.md §2a C11: per-source particle clouds reweighted by the SRP
    # surface with rival-source neighborhoods suppressed).
    smoother: str = "ema"
    num_particles: int = 256
    particle_step_std_rad: float = 0.05
    particle_resample_threshold: float = 0.5
    particle_seed: int = 0
    # Binaural masking
    mask_threshold_rad: float = 0.5
    mask_sharpness: float = 8.0

    @property
    def needs(self) -> frozenset:
        """What this algo needs besides the analysis (``ALGOS``)."""
        return ALGOS[self.name]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the distributed block step (C13/C14)."""
    time_shards: int = 1              # sequence/context parallel axis
    channel_shards: int = 1           # tensor-parallel axis (mics / bins)

    @property
    def num_devices(self) -> int:
        return self.time_shards * self.channel_shards


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    name: str = "config1"
    sample_rate: int = 16000
    block_len: int = 4096             # samples fed per process_block call
    array: ArrayConfig = ArrayConfig()
    stft: StftConfig = StftConfig()
    algo: AlgoConfig = AlgoConfig()
    mesh: MeshConfig = MeshConfig()

    def __post_init__(self):
        if self.block_len % self.stft.hop != 0:
            raise ValueError("block_len must be a multiple of the STFT hop "
                             f"({self.block_len} % {self.stft.hop} != 0)")

    def validate(self) -> "PipelineConfig":
        """Cross-field checks, run when a pipeline consumes the config (not
        in __post_init__: --set overrides apply one at a time, so
        intermediate states may be transiently inconsistent)."""
        if self.algo.name not in ALGOS:
            raise ValueError(f"unknown algo {self.algo.name!r} ({self.name}): "
                             f"expected one of {'|'.join(ALGOS)}")
        if "synthesis" in self.algo.needs and not self.stft.synthesis:
            raise ValueError(
                f"algo {self.algo.name!r} produces audio and needs a "
                "synthesis window: set stft.synthesis=true (the srp/gcc "
                "analysis-only algos run with synthesis=false)")
        return self

    def geometry(self) -> geo.ArrayGeometry:
        return self.array.geometry(self.sample_rate)

    @property
    def frames_per_block(self) -> int:
        return self.block_len // self.stft.hop

    def config_hash(self) -> str:
        """Stable hash used to guard checkpoint/resume compatibility."""
        d = dataclasses.asdict(self)
        blob = json.dumps(d, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def _coerce(text: str, annot) -> object:
    """Parse a CLI string into the type a dataclass field expects."""
    if text.lower() in ("none", "null"):
        return None
    base = annot
    if hasattr(annot, "__origin__"):                # Optional[...] / Tuple[..]
        args = [a for a in getattr(annot, "__args__", ()) if a is not type(None)]
        base = args[0] if args else str
        if getattr(annot, "__origin__", None) is tuple or (
                hasattr(base, "__origin__") and base.__origin__ is tuple):
            return tuple(float(v) for v in text.split(","))
    if base is bool:
        return text.lower() in ("1", "true", "yes", "on")
    if base is int:
        return int(text)
    if base is float:
        return float(text)
    return text


def apply_overrides(cfg: "PipelineConfig", overrides) -> "PipelineConfig":
    """Apply ``section.field=value`` strings (CLI ``--set``) to a preset.

    The reference exposes every parameter as a constructor argument; this is
    the equivalent: any field of the nested frozen dataclasses is reachable,
    e.g. ``algo.gcc_bands=5``, ``stft.hop=128``, ``block_len=8192``,
    ``algo.band_hz=300,3400``.  Types are coerced from the field annotation.
    """
    for item in overrides or ():
        if "=" not in item:
            raise ValueError(f"--set expects section.field=value, got {item!r}")
        path, value = item.split("=", 1)
        parts = path.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        leaf_obj, field_name = objs[-1], parts[-1]
        # resolve string annotations (PEP 563: `from __future__ import
        # annotations` makes f.type a str)
        import typing
        hints = typing.get_type_hints(type(leaf_obj))
        if field_name not in hints:
            raise ValueError(
                f"unknown config field {path!r} (no {field_name!r} on "
                f"{type(leaf_obj).__name__})")
        new = dataclasses.replace(
            leaf_obj, **{field_name: _coerce(value, hints[field_name])})
        for obj, attr in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            new = dataclasses.replace(obj, **{attr: new})
        cfg = new
    return cfg


# ---------------------------------------------------------------------------
# The five acceptance presets (BASELINE.json:6-12)
# ---------------------------------------------------------------------------

CONFIG1 = PipelineConfig(
    name="config1", sample_rate=16000, block_len=4096,
    array=ArrayConfig(kind="linear", num_mics=2, spacing=0.1),
    stft=StftConfig(frame_len=512, hop=256, synthesis=False),
    algo=AlgoConfig(name="gcc"),
)

CONFIG2 = PipelineConfig(
    name="config2", sample_rate=16000, block_len=4096,
    array=ArrayConfig(kind="linear", num_mics=4, spacing=0.05),
    stft=StftConfig(frame_len=512, hop=256, synthesis=True),
    algo=AlgoConfig(name="delaysum", steer_azimuth_rad=0.0),
)

CONFIG3 = PipelineConfig(
    name="config3", sample_rate=16000, block_len=4096,
    array=ArrayConfig(kind="circular", num_mics=8, radius=0.05),
    stft=StftConfig(frame_len=512, hop=256, synthesis=False),
    algo=AlgoConfig(name="srp", grid_points=360),
)

CONFIG4 = PipelineConfig(
    name="config4", sample_rate=48000, block_len=12288,
    array=ArrayConfig(kind="circular", num_mics=8, radius=0.05),
    stft=StftConfig(frame_len=1024, hop=512, synthesis=True),
    algo=AlgoConfig(name="srp_mvdr", grid_points=360,
                    cov_forget=0.95, diag_load=1e-3),
)

CONFIG5 = PipelineConfig(
    name="config5", sample_rate=16000, block_len=4096,
    array=ArrayConfig(kind="circular", num_mics=16, radius=0.1),
    stft=StftConfig(frame_len=512, hop=256, synthesis=True),
    algo=AlgoConfig(name="track_mvdr", grid_points=360, num_sources=2,
                    cov_forget=0.9, diag_load=1e-3),
)

PRESETS = {c.name: c for c in (CONFIG1, CONFIG2, CONFIG3, CONFIG4, CONFIG5)}


def get_config(name: str) -> PipelineConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown config {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
