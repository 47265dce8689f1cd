"""yi-9b — llama-architecture GQA [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.  Pure full attention.
"""
from repro_torch.config import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    block_pattern=("attn",),
    attn=AttnConfig(kind="full", rope_base=10_000.0),
    tie_embeddings=False,
    subquadratic=False,
))
