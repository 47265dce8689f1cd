"""gemma3-12b — 5:1 local:global attention [hf:google/gemma-3].

48L d_model=3840 16H (GQA kv=8) head_dim=240 d_ff=15360 vocab=262144.
Five sliding-window (1024) layers per global layer; the global layers use
RoPE base 1e6, the local ones 1e4.  Tied embeddings.
"""
from repro_torch.config import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=240,
    d_ff=15_360,
    vocab_size=262_144,
    block_pattern=("local",) * 5 + ("attn",),
    attn=AttnConfig(kind="local", window=1024, rope_base=1_000_000.0,
                    rope_base_local=10_000.0),
    tie_embeddings=True,
    subquadratic=True,
    scan_group=6,
    notes="flagship for ISP vocab embedding (262k vocab); 5:1 local:global "
          "pattern scanned in groups of 6",
))
