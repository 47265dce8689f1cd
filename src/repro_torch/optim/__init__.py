from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm)
from repro_torch.optim.compression import (  # noqa: F401
    compressed_psum, int8_compress, int8_decompress)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
