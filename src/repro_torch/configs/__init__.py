"""Architecture configs the port serves.  Importing this package registers
them; each later slice adds the families it ports."""
from repro_torch.configs import (  # noqa: F401
    chameleon_34b,
    gemma3_12b,
    llama3_405b,
    llama4_scout_17b_a16e,
    musicgen_large,
    starcoder2_15b,
    yi_9b,
)
