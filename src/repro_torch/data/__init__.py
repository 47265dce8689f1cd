from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, MemmapTokenSource, ShardedLoader, SyntheticTokenSource,
    write_token_file)
