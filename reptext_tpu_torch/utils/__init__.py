"""Host-side helpers (numpy and PIL), copied from the JAX package's ``utils``."""
