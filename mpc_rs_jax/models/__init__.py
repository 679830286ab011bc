from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.models import costs, dynamics, noise, observation, reference

__all__ = ["CartPoleParams", "costs", "dynamics", "noise", "observation", "reference"]
