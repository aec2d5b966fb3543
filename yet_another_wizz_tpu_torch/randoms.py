"""Random point generators for correlation measurement randoms.

Capability parity with the reference ``yaw.randoms``
(yaw/randoms.py:37-363): generators producing uniform
sky positions — in a rectangular footprint (:class:`BoxRandoms`) or within
a HEALPix mask / probability map (:class:`HealPixRandoms`) — optionally
drawing weights and redshifts with replacement from supplied observed
values. The seed handling reproduces the reference's v1/v2-compatible
``SeedSequence`` spawning.

A copy of the JAX package's ``randoms.py`` (numpy only): the same seed
draws the same points in both packages.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.datachunk import (
    DataChunk,
    DataChunkInfo,
    HandlesDataChunk,
)
from yet_another_wizz_tpu_torch.utils.healpix import (
    ang2pix_ring,
    npix_to_nside,
    pix_bounds_ring,
)

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "BoxRandoms",
    "HealPixRandoms",
]

DEFAULT_SEED = 12345


class RandomsBase(ABC, HandlesDataChunk):
    """Base class for random generators.

    Subclasses implement :meth:`_draw_coords`; calling the generator with a
    sample size returns a structured data chunk with ``ra``/``dec`` in
    radian plus any drawn attributes.
    """

    def __init__(
        self,
        *,
        weights: NDArray | None = None,
        redshifts: NDArray | None = None,
        seed: int = DEFAULT_SEED,
    ) -> None:
        self._chunk_info = DataChunkInfo(
            has_weights=weights is not None,
            has_redshifts=redshifts is not None,
        )
        self.weights = None if weights is None else np.asarray(weights)
        self.redshifts = None if redshifts is None else np.asarray(redshifts)
        self.data_size = self.get_data_size()
        self.reseed(seed)

    def get_data_size(self) -> int:
        """Number of attached data samples to draw from, or -1 when
        neither weights nor redshifts are attached; raises ``ValueError``
        on mismatched lengths (reference:
        yaw/randoms.py:58-84)."""
        if self.weights is None and self.redshifts is None:
            return -1
        if self.weights is None:
            return len(self.redshifts)
        if self.redshifts is None:
            return len(self.weights)
        if len(self.weights) != len(self.redshifts):
            raise ValueError(
                "number of 'weights' and 'redshifts' to draw from does not match"
            )
        return len(self.weights)

    def reseed(self, seed: int | None = None) -> None:
        """Reset the random state (seed expansion identical to the
        reference for reproducibility of its catalogs)."""
        if seed is not None:
            self.seed = int(seed)
        spawned = np.random.SeedSequence(self.seed).spawn(1)[0]
        self.rng = np.random.default_rng(spawned)

    @abstractmethod
    def _draw_coords(self, probe_size: int) -> tuple[NDArray, NDArray]:
        """Draw uniform (ra, dec) in radian."""

    def _draw_attributes(self, probe_size: int) -> dict[str, NDArray]:
        attrs = {}
        if self.weights is not None and self.redshifts is not None:
            idx = self.rng.integers(0, len(self.weights), probe_size)
            attrs["weights"] = self.weights[idx]
            attrs["redshifts"] = self.redshifts[idx]
        elif self.weights is not None:
            attrs["weights"] = self.rng.choice(self.weights, probe_size)
        elif self.redshifts is not None:
            attrs["redshifts"] = self.rng.choice(self.redshifts, probe_size)
        return attrs

    def __call__(self, probe_size: int) -> NDArray:
        """Generate ``probe_size`` random points as a structured chunk."""
        ra, dec = self._draw_coords(probe_size)
        attrs = self._draw_attributes(probe_size)
        # generated values are finite by construction — skip the
        # full-column finiteness scan (reference:
        # yaw/randoms.py:148-150)
        return DataChunk.create(
            ra, dec, degrees=False, chkfinite=False, **attrs
        )

    def generate_dataframe(self, probe_size: int, *, degrees: bool = True):
        """Draw a new sample of random points into a pandas DataFrame,
        coordinates in degrees by default (reference:
        yaw/randoms.py:153-185)."""
        try:
            import pandas as pd
        except ImportError as err:  # pandas is an optional dependency
            raise ImportError(
                "optional dependency 'pandas' required to generate DataFrames"
            ) from err

        df = pd.DataFrame.from_records(self(probe_size))
        if degrees:
            df["ra"] = np.rad2deg(df["ra"])
            df["dec"] = np.rad2deg(df["dec"])
        return df


class BoxRandoms(RandomsBase):
    """Uniform randoms in a rectangular (ra, dec) footprint.

    Coordinates are given in degrees (like the reference); sampling is
    uniform on the sphere (cylindrical equal-area: uniform in ra and
    sin(dec)).
    """

    def __init__(
        self,
        ra_min: float,
        ra_max: float,
        dec_min: float,
        dec_max: float,
        *,
        weights: NDArray | None = None,
        redshifts: NDArray | None = None,
        seed: int = DEFAULT_SEED,
    ) -> None:
        super().__init__(weights=weights, redshifts=redshifts, seed=seed)
        self.ra_min, self.ra_max = np.deg2rad([ra_min, ra_max])
        self.dec_min, self.dec_max = np.deg2rad([dec_min, dec_max])
        if self.ra_min >= self.ra_max:
            raise ValueError("'ra_min' must be smaller than 'ra_max'")
        if self.dec_min >= self.dec_max:
            raise ValueError("'dec_min' must be smaller than 'dec_max'")

    def _draw_coords(self, probe_size: int) -> tuple[NDArray, NDArray]:
        x = self.rng.uniform(self.ra_min, self.ra_max, probe_size)
        y = self.rng.uniform(
            np.sin(self.dec_min), np.sin(self.dec_max), probe_size
        )
        return x, np.arcsin(y)


class HealPixRandoms(RandomsBase):
    """Uniform randoms within a HEALPix mask or probability map.

    Args:
        pixel_map:
            RING-ordered HEALPix map: boolean mask or per-pixel relative
            probability (non-finite values treated as zero).
        weights / redshifts:
            Optional observed values to draw with replacement.
        seed:
            Random seed.

    Implementation: rejection sampling over the bounding box of the
    non-zero pixels (padded by one pixel radius) — uniform positions in
    the box are kept with probability proportional to their pixel value.
    Exact for any map; efficiency equals the mean map value over the box
    instead of over the whole sphere, so small survey footprints sample
    efficiently.
    """

    def __init__(
        self,
        pixel_map: NDArray,
        *,
        weights: NDArray | None = None,
        redshifts: NDArray | None = None,
        seed: int = DEFAULT_SEED,
    ) -> None:
        super().__init__(weights=weights, redshifts=redshifts, seed=seed)
        pixel_map = np.asarray(pixel_map, dtype=np.float64)
        pixel_map = np.where(np.isfinite(pixel_map), pixel_map, 0.0)
        if np.any(pixel_map < 0.0):
            raise ValueError("'pixel_map' values must not be negative")
        if pixel_map.max() == 0.0:
            raise ValueError("'pixel_map' selects no area")
        self.nside = npix_to_nside(len(pixel_map))
        self.pixel_map = pixel_map / pixel_map.max()

        # bounding box of the covered pixels from per-pixel corner extents
        # (a center-based box would truncate polar-cap pixels, whose
        # longitude width pi/(4 ring) far exceeds the mean pixel size,
        # silently under-sampling footprints that touch the caps)
        covered = np.nonzero(self.pixel_map)[0]
        z_lo_p, z_hi_p, lon_lo_p, lon_hi_p = pix_bounds_ring(
            self.nside, covered
        )
        z_hi = min(float(z_hi_p.max()), 1.0)
        z_lo = max(float(z_lo_p.min()), -1.0)
        lon_lo, lon_hi = float(lon_lo_p.min()), float(lon_hi_p.max())
        pad = 1e-3 * np.sqrt(np.pi / len(pixel_map))
        if lon_hi - lon_lo >= 2.0 * np.pi - pad:
            lon_lo, lon_hi = 0.0, 2.0 * np.pi  # wraps: use the full circle
        self._z_range = (z_lo, z_hi)
        self._lon_range = (lon_lo, lon_hi)

        box_fraction = (z_hi - z_lo) / 2.0 * (lon_hi - lon_lo) / (2 * np.pi)
        mean_in_box = float(self.pixel_map.mean()) / max(box_fraction, 1e-12)
        self._efficiency = float(np.clip(mean_in_box, 1e-6, 1.0))

    def _draw_coords(self, probe_size: int) -> tuple[NDArray, NDArray]:
        ra_out = np.empty(probe_size)
        dec_out = np.empty(probe_size)
        filled = 0
        while filled < probe_size:
            batch = int((probe_size - filled) / self._efficiency * 1.1) + 64
            batch = min(batch, 20_000_000)
            ra = self.rng.uniform(*self._lon_range, batch) % (2.0 * np.pi)
            dec = np.arcsin(self.rng.uniform(*self._z_range, batch))
            pix = ang2pix_ring(self.nside, np.pi / 2.0 - dec, ra)
            accept = self.rng.uniform(0.0, 1.0, batch) < self.pixel_map[pix]
            ra, dec = ra[accept], dec[accept]
            take = min(len(ra), probe_size - filled)
            ra_out[filled : filled + take] = ra[:take]
            dec_out[filled : filled + take] = dec[:take]
            filled += take
        return ra_out, dec_out
