from mpc_rs_jax.parallel.mesh import make_mesh
from mpc_rs_jax.parallel.sharded_mppi import make_sharded_mppi

__all__ = ["make_mesh", "make_sharded_mppi"]
