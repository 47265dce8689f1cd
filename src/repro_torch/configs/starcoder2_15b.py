"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.  Pure full attention →
long_500k skipped.
"""
from repro_torch.config import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    block_pattern=("attn",),
    attn=AttnConfig(kind="full", rope_base=100_000.0),
    tie_embeddings=False,
    subquadratic=False,
))
