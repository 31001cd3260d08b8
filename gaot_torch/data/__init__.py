from .data_processor import POSEIDON_DATASETS, DataProcessor
from .graph_builder import GraphBuilder, prepare_fx_device_graphs
from .loader import BatchLoader, PrefetchLoader, make_static_fx_loader
from .readers import read_dataset

__all__ = [
    "BatchLoader",
    "DataProcessor",
    "GraphBuilder",
    "POSEIDON_DATASETS",
    "PrefetchLoader",
    "make_static_fx_loader",
    "prepare_fx_device_graphs",
    "read_dataset",
]
