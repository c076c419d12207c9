"""Data layer: metadata tables and splits, the segmentation dataset on the C++
prep, the loader and device feed, the replay buffer."""

from .loader import DeviceFeeder, Loader, cycle  # noqa: F401
from .metadata import Table, load_dataset_info, load_table  # noqa: F401
from .replay_buffer import ReplayBuffer  # noqa: F401
from .segmentation import LabelMapper, SegmentationDataset  # noqa: F401
