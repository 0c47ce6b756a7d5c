"""Memmap-backed snapshot storage (counterpart of
``nps_tpu/data/memmap_dataset.py``): per-role numpy memmaps (data,
baseline, conditioning, t_conditioning, spatial_conditioning), a
``<data_file>.yaml`` sidecar supplying the grid (``x`` or ``x1, x2, ...``)
and time metadata, lazy per-element transforms or eager precomputation to
temp memmaps with finalizer cleanup, and a load-all-into-RAM option.

Everything here is host-side numpy; elements are float32 arrays that the
loaders of ``nps_tpu_torch.data.pipeline`` collate and stage onto the
device. Empty roles are ``EMPTY`` (shape-(0,) float32).
"""

import os
import shutil
import weakref

import numpy as np

from nps_tpu_torch.utils.io import load_memmap, load_yaml
from nps_tpu_torch.utils.misc import random_timestr

EMPTY = np.zeros((0,), dtype=np.float32)
# the environment variable through which the training CLI hands its
# scratch directory to the preprocessing step
SCRATCH_ENV = "NPS_TORCH_SCRATCH_DIR"

_ROLES = ("data", "baseline", "conditioning", "t_conditioning",
          "spatial_conditioning")


def precompute_and_save_memmap(memmap_in, filename, transform, dtype):
    n = memmap_in.shape[0]
    element_shape = transform(np.asarray(memmap_in[0], dtype=dtype)).shape
    out = np.lib.format.open_memmap(filename, mode="w+", dtype=memmap_in.dtype,
                                    shape=(n, *element_shape))
    for i in range(n):
        out[i] = transform(np.asarray(memmap_in[i], dtype=dtype))
    del out
    return np.lib.format.open_memmap(filename, mode="r")


class MemMapDataset:
    """Index-able dataset of simulation snapshots stored as numpy memmaps."""

    def __init__(self, path, data_file, baseline_file=None, conditioning=None,
                 t_conditioning=None, spatial_conditioning=None,
                 data_transform=None, grid_transform=None,
                 baseline_transform=None, conditioning_transform=None,
                 t_conditioning_transform=None,
                 spatial_conditioning_transform=None, data_format="memmap",
                 dtype=np.float32, preprocess=False, preprocess_path=None,
                 load_all=False, **_ignored):
        assert data_format in ("memmap", "raggedmemmap"), \
            "data format must be memmap (fixed) or raggedmemmap (variable)"
        self.dtype = dtype
        self.data_format = data_format
        self.return_baseline = baseline_file is not None
        self.return_conditioning = conditioning is not None
        self.return_t_conditioning = t_conditioning is not None
        self.return_spatial_conditioning = spatial_conditioning is not None

        self.transforms = {
            "data": data_transform,
            "baseline": baseline_transform if self.return_baseline else None,
            "conditioning": (conditioning_transform
                             if self.return_conditioning else None),
            "t_conditioning": (t_conditioning_transform
                               if self.return_t_conditioning else None),
            "spatial_conditioning": (spatial_conditioning_transform
                                     if self.return_spatial_conditioning
                                     else None),
        }

        self.preprocess = (preprocess and data_format == "memmap" and
                           any(v is not None for v in self.transforms.values()))
        if preprocess and not self.preprocess:
            print("Overriding preprocess to False (no transforms specified, "
                  "or ragged storage -> transforms stay lazy)")
        if self.preprocess:
            # scratch-dir precedence: explicit arg > the CLI's crash-safe
            # TemporaryDirectory (train_cli.cli exports it via env; the OS
            # reaps it even on hard kill) > a tmp/ dir next to the data
            self.preprocess_dir = (preprocess_path
                                   or os.environ.get(SCRATCH_ENV)
                                   or os.path.join(path, "tmp"))
            os.makedirs(self.preprocess_dir, exist_ok=True)
        else:
            self.preprocess_dir = None

        self.data = {"data": load_memmap(data_format, path, data_file)}
        for role, name in [("baseline", baseline_file),
                           ("conditioning", conditioning),
                           ("t_conditioning", t_conditioning),
                           ("spatial_conditioning", spatial_conditioning)]:
            if name is not None:
                self.data[role] = load_memmap(data_format, path, name)

        # yaml sidecar: grid + time metadata
        self.config = load_yaml(os.path.join(path, data_file + ".yaml"))
        if "x" in self.config:
            self.x = np.asarray(self.config["x"], dtype=self.dtype)
            self.x_all = [self.x]
        else:
            x_keys = [k for k in self.config if k.startswith("x")]
            idxs = sorted(int(k[1:]) for k in x_keys if k[1:].isdigit())
            if not idxs:
                raise ValueError(f"Could not find a grid in {data_file}.yaml")
            if idxs != list(range(1, len(idxs) + 1)):
                raise ValueError(
                    f"Found grid keys {[f'x{i}' for i in idxs]}, expected "
                    f"{[f'x{i}' for i in range(1, len(idxs) + 1)]}")
            self.x_all = [np.asarray(self.config[f"x{i}"], dtype=self.dtype)
                          for i in idxs]
            if len(self.x_all) == 1:
                self.x = self.x_all[0]
            else:
                self.x = np.stack(
                    np.meshgrid(*self.x_all, indexing="ij"), axis=-1)
        self.tmin = self.config["tmin"]
        self.tmax = self.config["tmax"]
        self.dt = self.config["dt"]

        if grid_transform is not None:
            self.x = grid_transform(self.x)

        if self.preprocess:
            postfix = random_timestr()
            print(f"Preprocessing dataset '{path}'")
            self.preprocess_output = {}
            for role in _ROLES:
                if role not in self.data or self.transforms[role] is None:
                    continue
                save_name = os.path.join(self.preprocess_dir,
                                         f"{role}_{postfix}.npy")
                self.data[role] = precompute_and_save_memmap(
                    self.data[role], save_name, self.transforms[role],
                    self.dtype)
                self.transforms[role] = None  # applied eagerly
                self.preprocess_output[role] = save_name
                print(f"Preprocessed {role}, saved to {save_name}")
            self._finalizer = weakref.finalize(
                self, _delete_files, dict(self.preprocess_output))

        if load_all:
            # ragged stores are per-element (offsets-indexed): materialise
            # element lists; fixed-shape memmaps load as one dense array
            self.data = {
                k: ([v[i] for i in range(len(v))]
                    if not hasattr(v, "shape") else np.asarray(v[:]))
                for k, v in self.data.items()}

    def cleanup(self):
        if hasattr(self, "_finalizer"):
            self._finalizer()

    def __len__(self):
        return len(self.data["data"])

    def _get_role(self, role, idx):
        if role not in self.data:
            return EMPTY
        el = np.asarray(self.data[role][idx], dtype=self.dtype)
        t = self.transforms.get(role)
        return t(el) if t is not None else el

    def __getitem__(self, idx):
        """Returns (u_base, u, x, cond, t_cond, spatial_cond)."""
        return (self._get_role("baseline", idx),
                self._get_role("data", idx),
                self.x,
                self._get_role("conditioning", idx),
                self._get_role("t_conditioning", idx),
                self._get_role("spatial_conditioning", idx))


def _delete_files(paths):
    for p in paths.values():
        try:
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)
        except OSError:
            pass
