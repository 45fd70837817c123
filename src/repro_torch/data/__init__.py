from .synthetic import SyntheticSpec, make_classification_dataset
from .partition import partition_by_class, partition_iid
from .loader import DeviceDataset, FLDataset

__all__ = ["SyntheticSpec", "make_classification_dataset",
           "partition_by_class", "partition_iid", "DeviceDataset",
           "FLDataset"]
