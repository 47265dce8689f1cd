"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry
their own up-projections (mLSTM expand=2, sLSTM proj factor 4/3).  Alternating
mlstm/slstm pattern; fully recurrent → sub-quadratic, runs long_500k.
"""
from repro_torch.config import AttnConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm", "slstm"),
    attn=AttnConfig(kind="full"),
    ssm=SSMConfig(num_heads=4, expand=2, chunk_size=128, conv_width=4),
    tie_embeddings=True,
    subquadratic=True,
    notes="sLSTM scalar-memory + mLSTM matrix-memory blocks; no attention, no KV cache",
))
