"""Data layer of the port: client-partitioned datasets (CIFAR, FEMNIST,
ImageNet and PersonaChat), sampler, loader (with the native batch path and
the prefetch thread), transforms and GPT-2's tokenizer, numpy host-side."""

from commefficient_torch.data_utils import transforms
from commefficient_torch.data_utils.fed_cifar import FedCIFAR10, FedCIFAR100
from commefficient_torch.data_utils.fed_dataset import FedDataset
from commefficient_torch.data_utils.fed_emnist import FedEMNIST
from commefficient_torch.data_utils.fed_imagenet import FedImageNet
from commefficient_torch.data_utils.fed_persona import (
    FedPERSONA,
    make_personachat_collate_fn,
)
from commefficient_torch.data_utils.fed_sampler import FedSampler
from commefficient_torch.data_utils.loader import (
    FedLoader,
    PrefetchLoader,
    cv_collate,
)

fed_datasets = {"CIFAR10": 10, "CIFAR100": 100, "EMNIST": 62,
                "ImageNet": 1000, "PERSONA": -1}


def num_classes_of_dataset(dataset_name):
    return fed_datasets[dataset_name]


__all__ = ["FedDataset", "FedCIFAR10", "FedCIFAR100", "FedEMNIST",
           "FedImageNet", "FedPERSONA", "FedSampler", "FedLoader",
           "PrefetchLoader", "cv_collate", "make_personachat_collate_fn",
           "transforms", "fed_datasets", "num_classes_of_dataset"]
