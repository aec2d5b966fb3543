"""The benchmark's own cosmology: Planck 2015 as astropy defines it.

Flat FLRW with photons from the CMB temperature and three neutrino species,
one of them massive (0.06 eV), their density interpolated between the
relativistic and non-relativistic regimes as in Komatsu et al. (2011). The
parameters are those of Planck Collaboration (2016) XIII, table 4, the
upstream yet_another_wizz's default cosmology. Plain NumPy; written apart
from the program so that the reference and the mock generator depend on
nothing the program computes.
"""

from __future__ import annotations

import numpy as np

C_KM_S = 299_792.458
C_M_S = 299_792_458.0
G_SI = 6.67430e-11
SIGMA_SB_SI = 5.670374419e-8
MPC_M = 3.0856775814913673e22
K_B_EV = 8.617333262e-5
NU_PREFACTOR = 0.22710731766  # 7/8 (4/11)^(4/3)
NU_K, NU_P = 0.3173, 1.83

PLANCK15 = dict(
    H0=67.74, Om0=0.3089, Tcmb0=2.7255, Neff=3.046, m_nu=(0.0, 0.0, 0.06)
)
QUADRATURE_ORDER = 128


class Planck15:
    """Distances of the flat Planck 2015 cosmology, in Mpc."""

    def __init__(self, H0=67.74, Om0=0.3089, Tcmb0=2.7255, Neff=3.046,
                 m_nu=(0.0, 0.0, 0.06)) -> None:
        self.H0, self.Om0, self.Neff = H0, Om0, Neff
        h0_si = H0 * 1e3 / MPC_M
        rho_crit = 3.0 * h0_si**2 / (8.0 * np.pi * G_SI)
        self.Ogamma0 = 4.0 * SIGMA_SB_SI * Tcmb0**4 / C_M_S**3 / rho_crit
        m_nu = np.asarray(m_nu, dtype=np.float64)
        species = int(np.floor(Neff))
        massive = m_nu[m_nu > 0]
        self.massless = species - len(massive)
        self.per_species = Neff / species
        t_nu = Tcmb0 * (4.0 / 11.0) ** (1.0 / 3.0)
        self.nu_y = massive / (K_B_EV * t_nu)
        self.Ode0 = 1.0 - Om0 - self.Ogamma0 * (1.0 + self._nu_per_gamma(0.0))
        self.nodes, self.node_weights = np.polynomial.legendre.leggauss(
            QUADRATURE_ORDER
        )

    def _nu_per_gamma(self, z):
        z = np.asarray(z, dtype=np.float64)
        y = self.nu_y.reshape((-1,) + (1,) * z.ndim) / (1.0 + z)
        massive = ((1.0 + (NU_K * y) ** NU_P) ** (1.0 / NU_P)).sum(axis=0)
        return NU_PREFACTOR * self.per_species * (massive + self.massless)

    def efunc(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        radiation = self.Ogamma0 * (1.0 + self._nu_per_gamma(z))
        return np.sqrt(radiation * zp1**4 + self.Om0 * zp1**3 + self.Ode0)

    def comoving_distance(self, z):
        """Line-of-sight comoving distance: c/H0 times the integral of
        1/E over [0, z] by Gauss-Legendre quadrature."""
        z = np.atleast_1d(np.asarray(z, dtype=np.float64))
        half = 0.5 * z
        points = half[None, :] * (self.nodes[:, None] + 1.0)
        integral = half * (self.node_weights[:, None] / self.efunc(points)).sum(0)
        return C_KM_S / self.H0 * integral

    def angular_diameter_distance(self, z):
        z = np.atleast_1d(np.asarray(z, dtype=np.float64))
        return self.comoving_distance(z) / (1.0 + z)
