"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (kv=32 → MHA) d_ff=8192 vocab=2048.  The EnCodec audio
frontend is a STUB (``models/frontend.AudioFrontendStub``): prefill takes
precomputed frame embeddings (``batch["embeddings"]``); the backbone is a
standard decoder over the 2048-entry codebook.  Pure full
attention → long_500k skipped.
"""
from repro_torch.config import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=("attn",),
    attn=AttnConfig(kind="full", rope_base=10_000.0),
    frontend="audio",
    tie_embeddings=True,
    subquadratic=False,
))
