from mpc_rs_jax.io.cobs import cobs_decode, cobs_encode, native_available
from mpc_rs_jax.io.packets import Control, Sensor, Sensor2, Sensor3, State

__all__ = [
    "cobs_decode",
    "cobs_encode",
    "native_available",
    "Control",
    "Sensor",
    "Sensor2",
    "Sensor3",
    "State",
]
