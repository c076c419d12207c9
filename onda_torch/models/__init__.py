"""The DeepLab-v2 family in PyTorch."""

from .deeplabv2 import DeepLabV2, build_deeplab_v2  # noqa: F401
