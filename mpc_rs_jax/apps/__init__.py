"""Reference-example applications as thin configs over the library.

The reference keeps ~4.5k LoC of behavior in copy-pasted example binaries
(SURVEY §1: "the library layer is tiny; nearly all behavior lives in the
examples"). Here that inverts: each reference example is a small runner
over first-class library components, dispatched by
``python -m mpc_rs_jax.apps.run <name>``.
"""

from mpc_rs_jax.apps.registry import EXAMPLES, get_example

__all__ = ["EXAMPLES", "get_example"]
