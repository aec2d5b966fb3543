"""Cosmological distance computations and correlation-scale conversion.

Capability parity with the reference ``yaw.cosmology``
(yaw/cosmology.py:38-343): a pluggable cosmology
interface, a default Planck 2015 model, conversion of physical/comoving
correlation scales to angles at a given redshift, and redshift-binning
generators (linear / comoving / logspace).

The reference delegates to ``astropy.cosmology``; this environment has no
astropy, so a self-contained FLRW model is implemented here (standard
Friedmann equations with photons, massless/massive neutrinos via the
Komatsu et al. 2011 fitting formula, curvature, and a cosmological
constant). When astropy *is* installed, its FLRW instances are accepted
anywhere a cosmology is expected (duck-typed via ``comoving_distance`` /
``angular_diameter_distance``).

Distances are computed with fixed-order Gauss-Legendre quadrature,
vectorised over redshift, accurate to ~1e-12 relative for smooth E(z).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Union

import numpy as np

from yet_another_wizz_tpu_torch.binning import Binning
from yet_another_wizz_tpu_torch.options import BinMethodAuto, Closed, Unit

if TYPE_CHECKING:
    from collections.abc import Callable

    from numpy.typing import ArrayLike, NDArray

__all__ = [
    "CustomCosmology",
    "FLRWCosmology",
    "Planck15",
    "RedshiftBinningFactory",
    "Scales",
    "cosmology_is_equal",
    "get_default_cosmology",
    "new_scales",
]

# physical constants (CGS / conventional units, CODATA 2018)
_C_KM_S = 299792.458  # speed of light [km/s]
_C_CM_S = 2.99792458e10  # speed of light [cm/s]
_G_CGS = 6.67430e-8  # gravitational constant [cm^3 g^-1 s^-2]
_SIGMA_SB = 5.670374419e-5  # Stefan-Boltzmann [erg cm^-2 s^-1 K^-4]
_K_B = 1.380649e-16  # Boltzmann [erg/K]
_EV_ERG = 1.602176634e-12  # 1 eV in erg
_MPC_CM = 3.0856775814913673e24  # 1 Mpc in cm

# Komatsu et al. (2011) fitting formula for the massive-neutrino density,
# identical to the approximation used by astropy's FLRW implementation.
_NU_PREFAC = 0.22710731766  # 7/8 * (4/11)^(4/3)
_NU_K = 0.3173
_NU_P = 1.83


class CustomCosmology(ABC):
    """Interface for user-defined cosmological models.

    Any object providing ``comoving_distance`` and
    ``angular_diameter_distance`` (both returning Mpc) is accepted by the
    correlation-scale conversion.
    """

    @abstractmethod
    def comoving_distance(self, z: ArrayLike) -> ArrayLike:
        """Line-of-sight comoving distance in Mpc at redshift(s) ``z``."""

    @abstractmethod
    def angular_diameter_distance(self, z: ArrayLike) -> ArrayLike:
        """Angular diameter distance in Mpc at redshift(s) ``z``."""


def _as_value(quantity):
    """Unwrap an astropy Quantity (duck-typed) into a plain array/float."""
    return getattr(quantity, "value", quantity)


def _gauss_legendre_nodes(order: int) -> tuple[NDArray, NDArray]:
    nodes, weights = np.polynomial.legendre.leggauss(order)
    return nodes, weights


class FLRWCosmology(CustomCosmology):
    """Self-contained FLRW cosmology with radiation, matter, curvature and a
    cosmological constant.

    Follows the same conventions as astropy: ``Om0`` is the density of
    non-relativistic matter today *excluding* massive neutrinos; photons and
    neutrinos are derived from ``Tcmb0``, ``Neff`` and ``m_nu``; for
    ``Ode0=None`` the model is flat.

    Args:
        H0: Hubble constant [km/s/Mpc].
        Om0: Matter density parameter today.
        Ode0: Dark-energy density parameter (``None`` -> flat universe).
        Tcmb0: CMB temperature today [K]; 0 disables radiation.
        Neff: Effective number of neutrino species.
        m_nu: Neutrino masses [eV], one entry per species.
        Ob0: Baryon density (informational only).
        name: Optional model name used for serialisation.
    """

    __slots__ = (
        "H0", "Om0", "Ode0", "Ok0", "Tcmb0", "Neff", "m_nu", "Ob0", "name",
        "_Ogamma0", "_nu_y", "_n_massless", "_neff_per_nu", "_gl_nodes",
        "_gl_weights",
    )

    def __init__(
        self,
        H0: float,
        Om0: float,
        Ode0: float | None = None,
        *,
        Tcmb0: float = 0.0,
        Neff: float = 3.046,
        m_nu: ArrayLike = (),
        Ob0: float | None = None,
        name: str | None = None,
    ) -> None:
        self.H0 = float(H0)
        self.Om0 = float(Om0)
        self.Tcmb0 = float(Tcmb0)
        self.Neff = float(Neff)
        self.m_nu = np.atleast_1d(np.asarray(m_nu, dtype=np.float64))
        self.Ob0 = Ob0
        self.name = name

        h0_inv_s = self.H0 * 1.0e5 / _MPC_CM
        rho_crit = 3.0 * h0_inv_s**2 / (8.0 * np.pi * _G_CGS)  # [g/cm^3]
        if self.Tcmb0 > 0:
            rho_gamma = 4.0 * _SIGMA_SB * self.Tcmb0**4 / _C_CM_S**3  # [g/cm^3]
            self._Ogamma0 = rho_gamma / rho_crit
        else:
            self._Ogamma0 = 0.0

        # astropy convention: floor(Neff) neutrino species, each carrying
        # Neff/floor(Neff) effective degrees of freedom; the mass vector
        # must name every species (or none) — silently inventing phantom
        # massless species would change Ode0 and every distance
        n_nu = int(np.floor(self.Neff)) if self.Neff > 0 else 0
        if len(self.m_nu):
            if n_nu == 0:
                raise ValueError(
                    "m_nu was given but Neff < 1 provides no neutrino "
                    "species to carry the masses"
                )
            if len(self.m_nu) != n_nu:
                raise ValueError(
                    f"unexpected number of neutrino masses: expected "
                    f"{n_nu} (= floor(Neff)), got {len(self.m_nu)}"
                )
        massive = self.m_nu[self.m_nu > 0]
        self._n_massless = n_nu - len(massive)
        self._neff_per_nu = self.Neff / n_nu if n_nu else 0.0
        if len(massive) and self.Tcmb0 > 0:
            t_nu0 = self.Tcmb0 * (4.0 / 11.0) ** (1.0 / 3.0)
            kt_ev = _K_B * t_nu0 / _EV_ERG  # neutrino temperature in eV
            self._nu_y = massive / kt_ev
        else:
            self._nu_y = np.empty(0)

        onu_gamma0 = self._nu_density_per_gamma(0.0)
        if Ode0 is None:
            self.Ok0 = 0.0
            self.Ode0 = 1.0 - self.Om0 - self._Ogamma0 * (1.0 + onu_gamma0)
        else:
            self.Ode0 = float(Ode0)
            self.Ok0 = (
                1.0 - self.Om0 - self.Ode0 - self._Ogamma0 * (1.0 + onu_gamma0)
            )

        self._gl_nodes, self._gl_weights = _gauss_legendre_nodes(80)

    def __repr__(self) -> str:
        label = self.name or type(self).__name__
        return f"{label}(H0={self.H0}, Om0={self.Om0}, Ode0={self.Ode0:.4f})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, FLRWCosmology):
            return NotImplemented
        return (
            self.H0 == other.H0
            and self.Om0 == other.Om0
            and self.Ode0 == other.Ode0
            and self.Tcmb0 == other.Tcmb0
            and self.Neff == other.Neff
            and np.array_equal(self.m_nu, other.m_nu)
        )

    __hash__ = None

    @property
    def hubble_distance(self) -> float:
        """Hubble distance c/H0 in Mpc."""
        return _C_KM_S / self.H0

    def _nu_density_per_gamma(self, z: ArrayLike) -> NDArray | float:
        """Neutrino energy density relative to the photon density.

        Uses the Komatsu et al. (2011) interpolation between the
        relativistic and non-relativistic regimes for massive species.
        """
        if self.Neff <= 0:
            return 0.0
        if len(self._nu_y) == 0:
            # all species relativistic (no masses, or Tcmb0 == 0): the
            # density carries the FULL Neff — including fractional Neff
            # in (0, 1), where the species count floor(Neff) is zero
            return _NU_PREFAC * self.Neff

        z = np.asarray(z, dtype=np.float64)
        y = self._nu_y.reshape((-1,) + (1,) * z.ndim) / (1.0 + z)
        per_species = (1.0 + (_NU_K * y) ** _NU_P) ** (1.0 / _NU_P)
        rel_mass = per_species.sum(axis=0) + self._n_massless
        return _NU_PREFAC * self._neff_per_nu * rel_mass

    def efunc(self, z: ArrayLike) -> NDArray:
        """Dimensionless Hubble parameter E(z) = H(z)/H0."""
        z = np.asarray(z, dtype=np.float64)
        zp1 = 1.0 + z
        o_rad = self._Ogamma0 * (1.0 + self._nu_density_per_gamma(z))
        e2 = (
            o_rad * zp1**4
            + self.Om0 * zp1**3
            + self.Ok0 * zp1**2
            + self.Ode0
        )
        return np.sqrt(e2)

    def inv_efunc(self, z: ArrayLike) -> NDArray:
        """1 / E(z)."""
        return 1.0 / self.efunc(z)

    def comoving_distance(self, z: ArrayLike) -> NDArray:
        """Line-of-sight comoving distance in Mpc.

        Integrates c/H0 * int_0^z dz'/E(z') by mapping a fixed
        Gauss-Legendre rule onto [0, z] for every requested redshift
        (vectorised; exact to quadrature accuracy for smooth E).
        """
        z = np.asarray(z, dtype=np.float64)
        scalar = z.ndim == 0
        z = np.atleast_1d(z)

        half = 0.5 * z
        nodes = half[None, :] * (self._gl_nodes[:, None] + 1.0)
        integral = half * np.sum(
            self._gl_weights[:, None] * self.inv_efunc(nodes), axis=0
        )
        result = self.hubble_distance * integral
        return result[0] if scalar else result

    def comoving_transverse_distance(self, z: ArrayLike) -> NDArray:
        """Transverse comoving distance D_M in Mpc (handles curvature)."""
        dc = self.comoving_distance(z)
        if self.Ok0 == 0.0:
            return dc
        sqrt_ok = np.sqrt(np.abs(self.Ok0))
        dh = self.hubble_distance
        x = sqrt_ok * dc / dh
        if self.Ok0 > 0:
            return dh / sqrt_ok * np.sinh(x)
        return dh / sqrt_ok * np.sin(x)

    def angular_diameter_distance(self, z: ArrayLike) -> NDArray:
        """Angular diameter distance D_A = D_M / (1+z) in Mpc."""
        z = np.asarray(z, dtype=np.float64)
        return self.comoving_transverse_distance(z) / (1.0 + z)

    def redshift_at_comoving_distance(self, dist_mpc: ArrayLike) -> NDArray:
        """Invert :meth:`comoving_distance` via bisection."""
        target = np.atleast_1d(np.asarray(dist_mpc, dtype=np.float64))
        scalar = np.ndim(dist_mpc) == 0

        z_hi = np.full_like(target, 2.0)
        for _ in range(64):  # expand bracket
            too_low = self.comoving_distance(z_hi) < target
            if not np.any(too_low):
                break
            z_hi = np.where(too_low, z_hi * 2.0, z_hi)

        z_lo = np.zeros_like(target)
        for _ in range(100):  # bisection to ~machine precision in z
            z_mid = 0.5 * (z_lo + z_hi)
            below = self.comoving_distance(z_mid) < target
            z_lo = np.where(below, z_mid, z_lo)
            z_hi = np.where(below, z_hi, z_mid)
        result = 0.5 * (z_lo + z_hi)
        return result[0] if scalar else result


Planck15 = FLRWCosmology(
    H0=67.74,
    Om0=0.3089,
    Tcmb0=2.7255,
    Neff=3.046,
    m_nu=(0.0, 0.0, 0.06),
    Ob0=0.0486,
    name="Planck15",
)
"""Planck Collaboration (2016) paper XIII, table 4 (TT, TE, EE + lowP +
lensing + ext) — the reference's default cosmology."""


TypeCosmology = Union[FLRWCosmology, CustomCosmology]


def get_default_cosmology() -> FLRWCosmology:
    """The default Planck 2015 cosmology."""
    return Planck15


def cosmology_is_equal(cosmo1, cosmo2) -> bool:
    """Compare two cosmologies; instances of :class:`CustomCosmology`
    without ``==`` support compare equal to each other by convention
    (mirrors the reference behaviour for custom models)."""
    for cosmo in (cosmo1, cosmo2):
        if not _is_cosmology(cosmo):
            raise TypeError(f"{cosmo!r} is not a valid cosmology type")

    is_flrw1 = isinstance(cosmo1, FLRWCosmology)
    is_flrw2 = isinstance(cosmo2, FLRWCosmology)
    if is_flrw1 and is_flrw2:
        return cosmo1 == cosmo2
    if is_flrw1 != is_flrw2:
        return False
    # two custom models compare equal by convention (cannot be introspected)
    return True


def _is_cosmology(obj) -> bool:
    return isinstance(obj, (FLRWCosmology, CustomCosmology)) or (
        hasattr(obj, "comoving_distance")
        and hasattr(obj, "angular_diameter_distance")
    )


class Scales(ABC):
    """Base class for correlation scale limits in a specific unit.

    Stores parallel arrays of lower and upper scale limits and converts them
    to angles in radian at a given redshift, see :meth:`get_angle_radian`.
    """

    scale_min: NDArray
    scale_max: NDArray
    unit: Unit

    def _set_scales(self, scale_min: ArrayLike, scale_max: ArrayLike) -> None:
        scale_min = np.atleast_1d(np.asarray(scale_min, dtype=np.float64))
        scale_max = np.atleast_1d(np.asarray(scale_max, dtype=np.float64))

        if scale_min.ndim != 1 or scale_max.ndim != 1:
            raise ValueError("min/max scales must be scalars or 1-dim arrays")
        if len(scale_min) != len(scale_max):
            raise ValueError("number of min and max scales does not match")
        if np.any(scale_max <= scale_min):
            raise ValueError("all min scales must be smaller than max scales")

        self.scale_min = scale_min
        self.scale_max = scale_max

    def __repr__(self) -> str:
        lo, hi = self.scale_min.tolist(), self.scale_max.tolist()
        return f"{type(self).__name__}(min={lo}, max={hi}, unit='{self.unit}')"

    @property
    def num_scales(self) -> int:
        """Number of scale ranges."""
        return len(self.scale_min)

    @abstractmethod
    def _compute_angle(
        self, scales: NDArray, redshift: float, cosmology: TypeCosmology
    ) -> NDArray:
        """Convert scale values to angles in radian at ``redshift``."""

    def get_angle_radian(
        self, redshift: float, cosmology: TypeCosmology | None = None
    ) -> tuple[NDArray, NDArray]:
        """Lower and upper angular limits in radian at the given redshift."""
        cosmology = cosmology or get_default_cosmology()
        return (
            self._compute_angle(self.scale_min, redshift, cosmology),
            self._compute_angle(self.scale_max, redshift, cosmology),
        )


class AngularScales(Scales):
    """Scale limits given directly as angles (rad/deg/arcmin/arcsec)."""

    _VALID = (Unit.rad, Unit.deg, Unit.arcmin, Unit.arcsec)
    _TO_DEG = {Unit.deg: 1.0, Unit.arcmin: 60.0, Unit.arcsec: 3600.0}

    def __init__(self, scale_min, scale_max, *, unit: Unit) -> None:
        self.unit = Unit(unit)
        if self.unit not in self._VALID:
            raise ValueError(f"'{unit}' is not a valid angular separation unit")
        self._set_scales(scale_min, scale_max)

    def _compute_angle(self, scales, redshift, cosmology) -> NDArray:
        if self.unit == Unit.rad:
            return scales
        return np.deg2rad(scales / self._TO_DEG[self.unit])


class PhysicalScales(Scales):
    """Scale limits as transverse proper distances (kpc/Mpc), converted via
    the angular diameter distance."""

    def __init__(self, scale_min, scale_max, *, unit: Unit) -> None:
        self.unit = Unit(unit)
        if self.unit not in (Unit.kpc, Unit.Mpc):
            raise ValueError(f"'{unit}' is not a valid physical separation unit")
        self._set_scales(scale_min, scale_max)

    def _compute_angle(self, scales, redshift, cosmology) -> NDArray:
        mpc = scales / 1000.0 if self.unit == Unit.kpc else scales
        dist = _as_value(cosmology.angular_diameter_distance(redshift))
        return mpc / dist


class ComovingScales(Scales):
    """Scale limits as transverse comoving distances (kpc/h, Mpc/h),
    converted via the comoving distance."""

    def __init__(self, scale_min, scale_max, *, unit: Unit) -> None:
        self.unit = Unit(unit)
        if self.unit not in (Unit.kpc_h, Unit.Mpc_h):
            raise ValueError(f"'{unit}' is not a valid comoving separation unit")
        self._set_scales(scale_min, scale_max)

    def _compute_angle(self, scales, redshift, cosmology) -> NDArray:
        mpc = scales / 1000.0 if self.unit == Unit.kpc_h else scales
        dist = _as_value(cosmology.comoving_distance(redshift))
        return mpc / dist


def new_scales(
    scale_min: ArrayLike, scale_max: ArrayLike, *, unit: Unit | str = Unit.kpc
) -> Scales:
    """Create a :class:`Scales` container of the appropriate subtype for the
    given unit (angular, physical or comoving)."""
    unit = Unit(unit)
    if unit in AngularScales._VALID:
        cls = AngularScales
    elif unit in (Unit.kpc, Unit.Mpc):
        cls = PhysicalScales
    else:
        cls = ComovingScales
    return cls(scale_min, scale_max, unit=unit)


class RedshiftBinningFactory:
    """Generate redshift binnings: linear in z, linear in comoving distance,
    or linear in log(1+z)."""

    def __init__(self, cosmology: TypeCosmology | None = None) -> None:
        self.cosmology = cosmology or get_default_cosmology()

    def linear(
        self, min: float, max: float, num_bins: int,
        *, closed: Closed | str = Closed.right,
    ) -> Binning:
        """Bin edges spaced linearly in redshift."""
        return Binning(np.linspace(min, max, num_bins + 1), closed=closed)

    def comoving(
        self, min: float, max: float, num_bins: int,
        *, closed: Closed | str = Closed.right,
    ) -> Binning:
        """Bin edges spaced linearly in comoving distance."""
        dists = _as_value(self.cosmology.comoving_distance(np.array([min, max])))
        dist_edges = np.linspace(dists[0], dists[1], num_bins + 1)

        if hasattr(self.cosmology, "redshift_at_comoving_distance"):
            edges = self.cosmology.redshift_at_comoving_distance(dist_edges)
        else:  # generic inversion for custom / astropy cosmologies
            from scipy.optimize import brentq

            def invert(d):
                return brentq(
                    lambda z: _as_value(self.cosmology.comoving_distance(z)) - d,
                    0.0,
                    max * 10.0 + 10.0,
                )

            edges = np.array([invert(d) for d in dist_edges])
        # pin the outer edges to the exact requested limits
        edges[0], edges[-1] = min, max
        return Binning(edges, closed=closed)

    def logspace(
        self, min: float, max: float, num_bins: int,
        *, closed: Closed | str = Closed.right,
    ) -> Binning:
        """Bin edges spaced linearly in ln(1+z)."""
        log_edges = np.linspace(np.log1p(min), np.log1p(max), num_bins + 1)
        return Binning(np.expm1(log_edges), closed=closed)

    def get_method(
        self, method: BinMethodAuto | str = BinMethodAuto.linear
    ) -> Callable[..., Binning]:
        """Look up one of the generator methods by name."""
        return getattr(self, str(BinMethodAuto(method)))
