"""llama4-scout-17b-a16e — MoE 16 experts top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.  Every layer: GQA
attention + (1 shared expert + 16 routed experts, top-1).  EP maps 1 expert
per model-axis shard on the 16-way production mesh — the cleanest possible
"send the token to the drive that owns the weights" cell.  Full attention →
long_500k skipped.
"""
from repro_torch.config import (AttnConfig, ModelConfig, MoEConfig,
                                register)

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    block_pattern=("moe",),
    attn=AttnConfig(kind="full", rope_base=500_000.0),
    moe=MoEConfig(num_experts=16, num_shared_experts=1, top_k=1,
                  d_ff_expert=8192, d_ff_shared=8192, capacity_factor=1.25),
    tie_embeddings=False,
    subquadratic=False,
))
