from pumipic_jax.models import pseudo_xgcm, pseudo_push_and_search, search2d  # noqa: F401
