"""Parameter flattening in the key form of the JAX package's checkpoints."""
