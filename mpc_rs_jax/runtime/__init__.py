from mpc_rs_jax.runtime.logger import CsvLogger
from mpc_rs_jax.runtime.loop import MultiRateConfig, run_multirate_loop, run_simple_loop

__all__ = ["CsvLogger", "MultiRateConfig", "run_multirate_loop", "run_simple_loop"]
