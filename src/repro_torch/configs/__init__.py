"""Architecture configs the port serves.  Importing this package registers
them; each later slice adds the families it ports."""
from repro_torch.configs import yi_9b  # noqa: F401
