"""Estimator models for correlation amplitudes and redshift recovery.

The "model families" of this framework are the correlation estimators
(how raw pair counts combine into an amplitude) and the redshift
recovery model (how amplitudes combine into n(z)). They are registered
here by name; the containers in
:mod:`yet_another_wizz_tpu_torch.correlation.corrfunc` select from this
registry.
"""

from yet_another_wizz_tpu_torch.models.estimators import (
    ESTIMATORS,
    davis_peebles,
    get_estimator,
    landy_szalay,
    scalar_correlation,
)

__all__ = [
    "ESTIMATORS",
    "davis_peebles",
    "get_estimator",
    "landy_szalay",
    "scalar_correlation",
]
