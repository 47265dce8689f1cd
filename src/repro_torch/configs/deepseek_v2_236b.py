"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed experts top-6 [arXiv:2405.04434].

60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400.  MLA caches only
the 512-dim compressed c_kv + 64-dim rope key per token (576 values/token —
KV-transfer compression, itself very ISP-flavoured).  MoE: 2 shared + 160
routed, top-6, d_ff_expert=1536 → EP shards 10 experts per model rank.
Full (MLA) attention → long_500k skipped.
"""
from repro_torch.config import AttnConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102_400,
    block_pattern=("mla_moe",),
    attn=AttnConfig(kind="mla", kv_lora_rank=512, qk_rope_dim=64,
                    qk_nope_dim=128, v_head_dim=128, q_lora_rank=1536,
                    rope_base=10_000.0),
    moe=MoEConfig(num_experts=160, num_shared_experts=2, top_k=6,
                  d_ff_expert=1536, d_ff_shared=1536, capacity_factor=1.25),
    tie_embeddings=False,
    subquadratic=False,
    remat="full",
    grad_accum=4,
    attn_chunk=1024,
))
