"""Neural-network pieces of the port (counterpart of paddle_tpu.nn)."""
