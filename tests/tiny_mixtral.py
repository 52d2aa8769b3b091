"""A tiny seeded ``MixtralForCausalLM`` checkpoint for the port's tests
(transformers writes it; the word-level tokenizer of
``tiny_models.build_tiny_llama``)."""

import os
import shutil

import torch


def build_tiny_mixtral(out_dir: str, hidden: int = 64, experts: int = 4,
                       seed: int = 0, intermediate: int = 64) -> str:
    """A seeded random ``MixtralForCausalLM`` (2 layers, top-2, 4 heads on
    2 KV heads) beside the tiny llama's word-level tokenizer."""
    from tiny_models import build_tiny_llama
    from transformers import MixtralConfig, MixtralForCausalLM

    words = build_tiny_llama(out_dir + "-tokenizer")
    os.makedirs(out_dir)
    for name in os.listdir(words):
        if name not in ("config.json", "model.safetensors",
                        "generation_config.json"):
            shutil.copy(os.path.join(words, name), out_dir)
    torch.manual_seed(seed)
    MixtralForCausalLM(MixtralConfig(
        vocab_size=1397, hidden_size=hidden, intermediate_size=intermediate,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=experts, num_experts_per_tok=2,
        max_position_embeddings=512, pad_token_id=0, bos_token_id=2,
        eos_token_id=3, tie_word_embeddings=False)).save_pretrained(out_dir)
    return out_dir
