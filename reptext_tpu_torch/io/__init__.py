"""Weight carry from Flax parameter trees into the port's modules."""
