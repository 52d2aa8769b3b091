"""The generator fine-tuning loss (the PyTorch port's counterpart of
``bergen_tpu/train/step.py``): next-token cross-entropy over the answer
tokens (``loss_mask * attention_mask``), divided by their count (at least
one).

The forward runs on the non-flat cache (``llama.init_cache(flat=False)``)
under the causal-and-pad mask, through the plain attention and plain
products: it is differentiated, and no kernel wrapper has a backward (each
raises when handed a tensor that requires grad).  JAX's differentiated
forward reaches no Pallas kernel either (flash prefill off by default, the
cache not flat).  ``remat`` checkpoints each decoder layer
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).
"""

from __future__ import annotations

import torch

from bergen_tpu_torch.models import llama


def causal_lm_loss(params, cfg: llama.LlamaConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, loss_mask: torch.Tensor,
                   remat: bool = True) -> torch.Tensor:
    """Mean next-token CE (f32 scalar) over positions where
    ``loss_mask * attention_mask`` is 1."""
    B, S = input_ids.shape
    dev = input_ids.device
    cache = llama.init_cache(cfg, B, S, flat=False)
    am = attention_mask.long()
    positions = (torch.cumsum(am, dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
    mask = causal[None] & am.bool()[:, None, :]
    logits = llama.forward(params, cfg, input_ids, positions, cache, mask,
                           remat=remat)
    logits = logits[:, :-1].float()
    targets = input_ids[:, 1:]
    w = (loss_mask[:, 1:] * attention_mask[:, 1:]).float()
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
        reduction="none").view(B, S - 1)
    return (ce * w).sum() / w.sum().clamp_min(1.0)
