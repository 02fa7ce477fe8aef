from pumipic_jax.parallel import mesh_axis  # noqa: F401
