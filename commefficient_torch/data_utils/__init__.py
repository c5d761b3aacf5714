"""Data layer of the port (the CIFAR path): client-partitioned datasets,
sampler, loader and transforms, numpy host-side."""

from commefficient_torch.data_utils import transforms
from commefficient_torch.data_utils.fed_cifar import FedCIFAR10, FedCIFAR100
from commefficient_torch.data_utils.fed_dataset import FedDataset
from commefficient_torch.data_utils.fed_sampler import FedSampler
from commefficient_torch.data_utils.loader import FedLoader, cv_collate

fed_datasets = {"CIFAR10": 10, "CIFAR100": 100}


def num_classes_of_dataset(dataset_name):
    return fed_datasets[dataset_name]


__all__ = ["FedDataset", "FedCIFAR10", "FedCIFAR100", "FedSampler",
           "FedLoader", "cv_collate", "transforms", "fed_datasets",
           "num_classes_of_dataset"]
