from mpc_rs_jax.utils.structs import as_vector_fn, clamp

__all__ = ["as_vector_fn", "clamp"]
