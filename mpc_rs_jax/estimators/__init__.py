from mpc_rs_jax.estimators.gaussian import Gaussian
from mpc_rs_jax.estimators.kf import kf_predict, kf_update_joseph
from mpc_rs_jax.estimators.ukf import (
    UkfParams,
    UkfState,
    merwe_weights,
    sigma_points,
    ukf_init,
    ukf_predict,
    ukf_update,
    unscented_transform,
)

__all__ = [
    "Gaussian",
    "kf_predict",
    "kf_update_joseph",
    "UkfParams",
    "UkfState",
    "merwe_weights",
    "sigma_points",
    "ukf_init",
    "ukf_predict",
    "ukf_update",
    "unscented_transform",
]
