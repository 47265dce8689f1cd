"""Vocabulary embedding and the greedy sampling head, unsharded (port of
the single-device branches of ``repro/core/embedding.py``)."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig

VOCAB_PAD = 32   # table rows padded to a multiple of this


def padded_vocab(vocab_size: int) -> int:
    return -(-vocab_size // VOCAB_PAD) * VOCAB_PAD


def gather_baseline(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> (B, S, D) rows of the table."""
    return table[tokens.long()]


def _logits_f32(x: torch.Tensor, w_head: torch.Tensor) -> torch.Tensor:
    """x @ w_headᵀ with fp32 output, like the reference's
    ``preferred_element_type=float32``: a bf16 product rounded to bf16
    before argmax would tie often at a 64k vocabulary.  On the card the
    product accumulates in fp32 and is written as fp32; on the CPU, which
    has no such kernel, the operands are widened first."""
    if x.device.type == "cuda":
        return torch.mm(x, w_head.t(), out_dtype=torch.float32)
    return x.float() @ w_head.float().t()


def sharded_logits_last(x_last: torch.Tensor, w_head: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """Full logits for the last position.  x_last: (B, D) -> (B, V) fp32."""
    return _logits_f32(x_last, w_head)[:, : cfg.vocab_size]


def greedy_sample(x_last: torch.Tensor, w_head: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Greedy next token (B,) int32; ties go to the lowest id, as with
    ``jnp.argmax``."""
    return sharded_logits_last(x_last, w_head, cfg).argmax(dim=-1).to(
        torch.int32)
