"""Models of the PyTorch port."""

from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig

__all__ = ["GPT", "GPTConfig"]
