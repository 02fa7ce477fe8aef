from pumipic_jax.io import checkpoint  # noqa: F401
