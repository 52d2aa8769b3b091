"""Generator fine-tuning (LoRA and full SFT) and Provence training: the
PyTorch port's counterpart of ``bergen_tpu/train/``."""
