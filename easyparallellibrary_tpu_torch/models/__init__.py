"""Models of the PyTorch port."""

from easyparallellibrary_tpu_torch.models.bert import (
    Bert, BertConfig, bert_large_config)
from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
from easyparallellibrary_tpu_torch.models.resnet import (
    ResNet, ResNetConfig, resnet18_config, resnet50_config)

__all__ = ["GPT", "GPTConfig", "Bert", "BertConfig", "bert_large_config",
           "ResNet", "ResNetConfig", "resnet18_config", "resnet50_config"]
