"""Host-side IO helpers (counterpart of ``nps_tpu/utils/io.py``): yaml
sidecars and numpy memmaps. Ragged (variable-length) stores auto-detect the
on-disk layout: the port's ``RaggedMemmap`` directories or reference-produced
mmap_ninja ``RaggedMmap`` directories, read with plain numpy
(``nps_tpu_torch/data/ragged.py``)."""

import os

import numpy as np
import yaml


def load_yaml(path):
    with open(path, "r") as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def save_yaml(path, obj):
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)


def load_memmap(data_format, data_dir, load_name):
    """Open a dataset file read-only without loading it into RAM."""
    if data_format == "memmap":
        return np.lib.format.open_memmap(
            os.path.join(data_dir, load_name + ".npy"), mode="r")
    if data_format == "raggedmemmap":
        from nps_tpu_torch.data.ragged import open_ragged

        return open_ragged(os.path.join(data_dir, load_name))
    raise ValueError(f"data format {data_format} not supported")
