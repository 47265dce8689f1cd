"""chameleon-34b — early-fusion VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  The modality frontend
(VQ-VAE image tokenizer) is a STUB (``models/frontend.VQFrontendStub``):
prefill takes precomputed patch embeddings (``batch["embeddings"]``); text
tokens embed normally.  Pure full
attention → long_500k skipped.
"""
from repro_torch.config import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    block_pattern=("attn",),
    attn=AttnConfig(kind="full", rope_base=10_000.0),
    frontend="vlm",
    tie_embeddings=False,
    subquadratic=False,
))
