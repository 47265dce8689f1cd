"""llama3-405b — GQA, 128k vocab [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.  FSDP flagship:
params+grads+m/v in bf16 → 3.24 TB state, 12.7 GB/chip on a 256-chip pod.
Pure full attention → long_500k skipped.
"""
from repro_torch.config import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53_248,
    vocab_size=128_256,
    block_pattern=("attn",),
    attn=AttnConfig(kind="full", rope_base=500_000.0),
    tie_embeddings=False,
    subquadratic=False,
    remat="full",
    optimizer_state_dtype="bfloat16",
    grad_accum=1,   # accum>1 re-gathers FSDP weights per micro — measured regression (§Perf)
    attn_chunk=1024,
    notes="optimizer m/v kept bf16 so total train state fits 256x16GB (see DESIGN.md §4)",
))
