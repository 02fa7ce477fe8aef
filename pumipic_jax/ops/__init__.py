from pumipic_jax.ops import geometry, interpolate, push, scatter, search  # noqa: F401
