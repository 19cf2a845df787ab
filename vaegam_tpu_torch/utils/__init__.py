"""Host utilities of the port (numpy/scipy; no JAX)."""
