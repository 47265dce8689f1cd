"""Architecture configs the port serves.  Importing this package registers
them; each later slice adds the families it ports."""
from repro_torch.configs import (  # noqa: F401
    chameleon_34b,
    deepseek_v2_236b,
    gemma3_12b,
    hymba_1_5b,
    llama3_405b,
    llama4_scout_17b_a16e,
    musicgen_large,
    starcoder2_15b,
    xlstm_125m,
    yi_9b,
)

ASSIGNED = (
    "xlstm-125m",
    "hymba-1.5b",
    "gemma3-12b",
    "yi-9b",
    "starcoder2-15b",
    "llama3-405b",
    "chameleon-34b",
    "musicgen-large",
    "llama4-scout-17b-a16e",
    "deepseek-v2-236b",
)
