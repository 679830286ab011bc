from mpc_rs_jax.controllers.mppi import MppiConfig, MppiStatus, mppi_solve

__all__ = ["MppiConfig", "MppiStatus", "mppi_solve"]
