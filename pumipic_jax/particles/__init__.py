from pumipic_jax.particles.structure import (  # noqa: F401
    ParticleStructure,
    CSR,
    DPS,
    CabM,
    SellCSigma,
    SCSInput,
    create_member_fields,
)
from pumipic_jax.particles import distribute, pfile  # noqa: F401
