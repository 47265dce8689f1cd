"""hymba-1.5b — parallel attention + mamba heads per layer [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hybrid-head blocks: every layer runs sliding-window attention heads and mamba
(SSM) heads in parallel on the same input, fuses, then MLP.  Hybrid →
sub-quadratic, runs long_500k.
"""
from repro_torch.config import AttnConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    block_pattern=("hybrid",),
    attn=AttnConfig(kind="local", window=1024),
    ssm=SSMConfig(state_dim=16, expand=2, conv_width=4, chunk_size=128),
    tie_embeddings=True,
    subquadratic=True,
    scan_group=1,
    notes="parallel attn+mamba heads; attn is sliding-window (hymba global KV is tiny meta tokens, stubbed)",
))
