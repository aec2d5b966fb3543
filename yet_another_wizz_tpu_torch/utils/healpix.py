"""Minimal HEALPix pixelisation math (RING ordering), pure numpy.

The reference uses the ``healpy`` C++ bindings for its HealPix-based random
generator (yaw/randoms.py:262-363); healpy is not
available in this environment, so the required subset is implemented here:
angle -> pixel (``ang2pix_ring``) and pixel -> center angle
(``pix2ang_ring``), following the standard HEALPix equations (Gorski et
al. 2005).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from numpy.typing import ArrayLike, NDArray

__all__ = [
    "ang2pix_ring",
    "npix_to_nside",
    "nside_to_npix",
    "pix2ang_ring",
    "pix_bounds_ring",
]


def nside_to_npix(nside: int) -> int:
    """Number of pixels of an nside resolution map."""
    return 12 * nside * nside


def npix_to_nside(npix: int) -> int:
    """Resolution parameter from the number of map pixels."""
    nside = int(round(np.sqrt(npix / 12.0)))
    if nside_to_npix(nside) != npix:
        raise ValueError(f"invalid number of healpix pixels: {npix}")
    return nside


def ang2pix_ring(nside: int, theta: ArrayLike, phi: ArrayLike) -> NDArray:
    """RING-ordered pixel index for colatitude ``theta`` and longitude
    ``phi`` (radian)."""
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) / (0.5 * np.pi)  # in [0, 4)

    pix = np.empty(len(z), dtype=np.int64)
    ncap = 2 * nside * (nside - 1)
    npix = nside_to_npix(nside)

    equatorial = za <= 2.0 / 3.0
    if np.any(equatorial):
        zeq, tteq = z[equatorial], tt[equatorial]
        temp1 = nside * (0.5 + tteq)
        temp2 = nside * zeq * 0.75
        jp = np.floor(temp1 - temp2).astype(np.int64)
        jm = np.floor(temp1 + temp2).astype(np.int64)
        ring = nside + 1 + jp - jm  # ring number counted from z = 2/3
        kshift = 1 - (ring & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = np.mod(ip, 4 * nside)
        pix[equatorial] = ncap + (ring - 1) * 4 * nside + ip

    polar = ~equatorial
    if np.any(polar):
        zpo, ttpo = z[polar], tt[polar]
        tp = ttpo - np.floor(ttpo)
        tmp = nside * np.sqrt(3.0 * (1.0 - za[polar]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ring = jp + jm + 1
        ip = np.floor(ttpo * ring).astype(np.int64)
        ip = np.mod(ip, 4 * ring)
        north = 2 * ring * (ring - 1) + ip
        south = npix - 2 * ring * (ring + 1) + ip
        pix[polar] = np.where(zpo > 0, north, south)

    return pix


def pix2ang_ring(nside: int, pix: ArrayLike) -> tuple[NDArray, NDArray]:
    """Center (colatitude, longitude) in radian of RING-ordered pixels."""
    pix = np.atleast_1d(np.asarray(pix, dtype=np.int64))
    npix = nside_to_npix(nside)
    if np.any((pix < 0) | (pix >= npix)):
        raise ValueError("pixel index out of range")
    ncap = 2 * nside * (nside - 1)

    z = np.empty(len(pix), dtype=np.float64)
    phi = np.empty(len(pix), dtype=np.float64)

    north = pix < ncap
    if np.any(north):
        p = pix[north]
        # ring index: invert p = 2 ring (ring - 1) + ip with ip < 4 ring
        ring = np.floor(0.5 * (1 + np.sqrt(1 + 2 * p))).astype(np.int64)
        too_big = 2 * ring * (ring - 1) > p
        ring[too_big] -= 1
        ip = p - 2 * ring * (ring - 1)
        z[north] = 1.0 - (ring**2) / (3.0 * nside**2)
        phi[north] = (ip + 0.5) * np.pi / (2.0 * ring)

    equatorial = (pix >= ncap) & (pix < npix - ncap)
    if np.any(equatorial):
        p = pix[equatorial] - ncap
        ring = p // (4 * nside) + nside
        ip = np.mod(p, 4 * nside)
        fodd = 0.5 * (1 + np.mod(ring + nside, 2))
        z[equatorial] = (2 * nside - ring) * 2.0 / (3.0 * nside)
        phi[equatorial] = (ip + 1 - fodd) * np.pi / (2.0 * nside)

    south = pix >= npix - ncap
    if np.any(south):
        p = npix - 1 - pix[south]
        ring = np.floor(0.5 * (1 + np.sqrt(1 + 2 * p))).astype(np.int64)
        too_big = 2 * ring * (ring - 1) > p
        ring[too_big] -= 1
        ip = p - 2 * ring * (ring - 1)
        z[south] = -1.0 + (ring**2) / (3.0 * nside**2)
        phi[south] = (4 * ring - ip - 0.5) * np.pi / (2.0 * ring)

    return np.arccos(np.clip(z, -1, 1)), np.mod(phi, 2 * np.pi)


def _ring_center_z(nside: int, ring: NDArray) -> NDArray:
    """z of a ring center by ring index counted from the north pole
    (1 .. 4 nside - 1); values outside that range clip to the poles."""
    ring = np.asarray(ring, dtype=np.float64)
    cap_n = 1.0 - ring**2 / (3.0 * nside**2)
    belt = (2.0 * nside - ring) * 2.0 / (3.0 * nside)
    cap_s = -1.0 + (4.0 * nside - ring) ** 2 / (3.0 * nside**2)
    z = np.where(
        ring < nside, cap_n, np.where(ring <= 3 * nside, belt, cap_s)
    )
    return np.clip(z, -1.0, 1.0)


def pix_bounds_ring(
    nside: int, pix: ArrayLike
) -> tuple[NDArray, NDArray, NDArray, NDArray]:
    """Per-pixel bounding extents ``(z_lo, z_hi, lon_lo, lon_hi)``.

    The vertical extent spans the centers of the adjacent rings (pixel
    corners touch them; ring 1 / ring 4 nside - 1 reach the poles), and
    the longitude extent spans the pixel's east/west corners at
    ``center +- pi / npix_in_ring``. Polar-cap pixels are much wider in
    longitude than their area suggests (ring ``i`` holds only ``4 i``
    pixels), so a bounding box built from pixel centers alone would
    truncate them. ``lon_lo`` may be negative when a pixel wraps 0.
    """
    pix = np.atleast_1d(np.asarray(pix, dtype=np.int64))
    npix = nside_to_npix(nside)
    if np.any((pix < 0) | (pix >= npix)):
        raise ValueError("pixel index out of range")
    ncap = 2 * nside * (nside - 1)

    ring = np.empty(len(pix), dtype=np.int64)
    north = pix < ncap
    if np.any(north):
        p = pix[north]
        r = np.floor(0.5 * (1 + np.sqrt(1 + 2 * p))).astype(np.int64)
        r[2 * r * (r - 1) > p] -= 1
        ring[north] = r
    equatorial = (pix >= ncap) & (pix < npix - ncap)
    if np.any(equatorial):
        ring[equatorial] = (pix[equatorial] - ncap) // (4 * nside) + nside
    south = pix >= npix - ncap
    if np.any(south):
        p = npix - 1 - pix[south]
        r = np.floor(0.5 * (1 + np.sqrt(1 + 2 * p))).astype(np.int64)
        r[2 * r * (r - 1) > p] -= 1
        ring[south] = 4 * nside - r

    npix_ring = 4 * np.minimum.reduce(
        [ring, np.full_like(ring, nside), 4 * nside - ring]
    )
    z_hi = np.where(ring == 1, 1.0, _ring_center_z(nside, ring - 1))
    z_lo = np.where(
        ring == 4 * nside - 1, -1.0, _ring_center_z(nside, ring + 1)
    )

    colat, lon = pix2ang_ring(nside, pix)
    half = np.pi / npix_ring
    return z_lo, z_hi, lon - half, lon + half
