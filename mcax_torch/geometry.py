"""Array geometry — the port's own copy of ``mcax/geometry.py`` (numpy only).

Re-designs the reference's ``mca::ArrayDescription`` (mcarray: mic positions +
pairwise distance queries) as a frozen dataclass of NumPy arrays with all
derived quantities (pair lists, pairwise distances, per-pair max physical lag,
candidate-DOA grids and their steering delays) precomputed on the host once,
so everything entering the block step is a static-shape constant.

Conventions (used consistently by gcc/srp/delaysum/mvdr):
  * Positions are metres, shape [C, dim] with dim in {2, 3}.
  * A far-field plane wave from azimuth theta propagates along
    -u(theta), u = [cos t, sin t(, 0)]; the signal observed at mic c is
    advanced by  t_c(theta) = -(r_c . u)/c_sound  relative to the origin
    (mics further along +u hear the wavefront earlier → negative delay).
  * Pair (i, j) TDOA is tau_ij(theta) = t_i(theta) - t_j(theta), matching the
    cross-power spectrum G = X_i * conj(X_j) whose phase is
    -omega (t_i - t_j); hence SRP steering multiplies G by e^{+j omega tau}.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SPEED_OF_SOUND = 343.0  # m/s, dry air at 20C


def linear_positions(num_mics: int, spacing: float) -> np.ndarray:
    """Uniform linear array along x, centred on the origin. [C, 2]."""
    x = (np.arange(num_mics) - (num_mics - 1) / 2.0) * spacing
    return np.stack([x, np.zeros_like(x)], axis=-1)


def circular_positions(num_mics: int, radius: float) -> np.ndarray:
    """Uniform circular array in the xy plane, first mic at angle 0. [C, 2]."""
    ang = 2.0 * np.pi * np.arange(num_mics) / num_mics
    return np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=-1)


def all_pairs(num_mics: int) -> np.ndarray:
    """All C(C-1)/2 unordered mic pairs (i < j), shape [P, 2] int32."""
    idx = [(i, j) for i in range(num_mics) for j in range(i + 1, num_mics)]
    return np.asarray(idx, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class ArrayGeometry:
    """Microphone array description + precomputed pair/DOA quantities.

    Reference analogue: mcarray's ArrayDescription class (positions and
    pairwise distance queries); here extended with everything the
    pipeline needs as static constants.
    """

    positions: np.ndarray          # [C, dim] float64, metres
    sample_rate: float             # Hz
    speed_of_sound: float = SPEED_OF_SOUND

    def __post_init__(self):
        pos = np.asarray(self.positions, dtype=np.float64)
        if pos.ndim != 2 or pos.shape[1] not in (2, 3):
            raise ValueError(f"positions must be [C, 2|3], got {pos.shape}")
        object.__setattr__(self, "positions", pos)

    # ---- basic queries -------------------------------------------------
    @property
    def num_mics(self) -> int:
        return self.positions.shape[0]

    @property
    def pairs(self) -> np.ndarray:
        return all_pairs(self.num_mics)

    @property
    def num_pairs(self) -> int:
        return self.pairs.shape[0]

    def pair_distances(self) -> np.ndarray:
        """Euclidean distance per pair, [P]."""
        p = self.pairs
        d = self.positions[p[:, 0]] - self.positions[p[:, 1]]
        return np.linalg.norm(d, axis=-1)

    def max_lag_samples(self) -> np.ndarray:
        """Per-pair maximum physical |TDOA| in samples (ceil), [P] int32.

        Used to clamp the GCC-PHAT peak search to physically possible lags
        (the reference restricts its cross-correlation search the same way).
        """
        tau = self.pair_distances() / self.speed_of_sound
        return np.ceil(tau * self.sample_rate).astype(np.int32)

    # ---- steering ------------------------------------------------------
    def doa_unit_vectors(self, azimuths_rad: np.ndarray) -> np.ndarray:
        """Unit propagation-source directions u(theta), [G, dim]."""
        az = np.asarray(azimuths_rad, dtype=np.float64)
        u = np.stack([np.cos(az), np.sin(az)], axis=-1)
        if self.positions.shape[1] == 3:
            u = np.concatenate([u, np.zeros_like(u[..., :1])], axis=-1)
        return u

    def mic_delays(self, azimuths_rad: np.ndarray) -> np.ndarray:
        """Per-mic arrival delay t_c(theta) in seconds, [G, C].

        t_c = -(r_c . u)/c ; mics further along +u hear the source earlier.
        """
        u = self.doa_unit_vectors(azimuths_rad)            # [G, dim]
        return -(u @ self.positions.T) / self.speed_of_sound

    def pair_tdoas(self, azimuths_rad: np.ndarray) -> np.ndarray:
        """Per-pair TDOA tau_ij = t_i - t_j in seconds, [G, P]."""
        t = self.mic_delays(azimuths_rad)                  # [G, C]
        p = self.pairs
        return t[:, p[:, 0]] - t[:, p[:, 1]]


def azimuth_grid(num_points: int = 360, start_deg: float = -180.0,
                 stop_deg: float = 180.0) -> np.ndarray:
    """Uniform azimuth candidate grid in radians, endpoint excluded. [G]."""
    az = np.linspace(start_deg, stop_deg, num_points, endpoint=False)
    return np.deg2rad(az)


def doa_from_tdoa(tdoa_s: np.ndarray, pair_distance_m: float,
                  speed_of_sound: float = SPEED_OF_SOUND) -> np.ndarray:
    """2-mic far-field DOA from a TDOA: theta = arccos(tau*c/d), radians.

    With tau_ij = t_i - t_j = (r_j - r_i).u / c, cos(theta) = tau*c/d where
    theta in [0, pi] is the angle between the source direction and the pair
    baseline r_j - r_i.  Mirrors the reference's binaural localisation
    geometry: a single pair only resolves the cone angle to the baseline
    (front-back ambiguous).
    """
    s = np.clip(tdoa_s * speed_of_sound / pair_distance_m, -1.0, 1.0)
    return np.arccos(s)


def validate_geometry(geom: ArrayGeometry) -> Tuple[bool, str]:
    """Sanity checks used by config validation and tests."""
    if geom.num_mics < 2:
        return False, "need at least 2 microphones"
    d = geom.pair_distances()
    if np.any(d <= 0):
        return False, "duplicate microphone positions"
    return True, "ok"
