"""Host-side helpers (numpy and PIL images, the metrics registry), copied from
the JAX package's ``utils``."""
