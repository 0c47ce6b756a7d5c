"""Load an ``nps_tpu`` parameter tree into a port ``state_dict``.

The inverse of ``nps_tpu.compat.torch_weights.convert_state_dict``: it takes
the JAX package's tree (nested dicts of numpy arrays, optionally under
``params`` and the wrapper's ``inner``) and returns PyTorch reference key
names and layouts:

- conv kernel            [*k, I, O] -> weight [O, I, *k]
- transposed-conv kernel [*k, I, O] -> weight [I, O, *k]  (U-Net Upsample)
- Dense kernel           [I, O]     -> weight [O, I]
- GroupNorm scale                    -> weight
- a path segment ``name_N``          -> ``name.N`` (list and Sequential slots)
- a Dilated ResNet conv ``block_B/conv_L`` -> ``processor.B.layers.2L`` (the
  reference's block list and its Sequential, activations at the odd slots)
- a mixture-of-experts block ``experts_I`` (``models/moe_fno.py``): JAX
  stacks its experts' leaves on a leading ``E`` axis; each leaf is split
  along it first, leaf ``[E, ...]`` under ``experts_I/...`` becoming ``E``
  leaves under ``experts.I.e....``, and each is then mapped by the rules
  above (so an expert's 2D 1x1 conv kernel ``[E, 1, 1, I, O]`` is read as
  the ``[1, 1, I, O]`` kernel it is, not as a 3D one); the gate
  ``gate_I`` is a Dense
- a BC encoder ``bc_encoder/{conv_in, conv_hK, out}`` -> the reference's
  Sequential ``bc_encoder.bc_encoder.{0, 2K + 2, 2N + 3}`` (N hidden convs:
  activations at the odd slots, the flatten before the ``Linear``)

Spectral weights stay split real ``[2, i, o, *modes]`` (``weights1..4``
in 3D).
"""

import re

import numpy as np
import torch

_INDEXED = re.compile(r"^(.*)_(\d+)$")
_TRANSPOSE_CONV = re.compile(r"(^|/)up_\d+/conv$")
_DRN_CONV = re.compile(r"(^|/)block_(\d+)/conv_(\d+)(?=/|$)")
_EXPERTS = re.compile(r"^experts_\d+$")
_BC_LAYER = re.compile(r"(^|/)bc_encoder/(conv_in|conv_h(\d+)|out)(?=/|$)")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _split_experts(leaves):
    """Split every leaf under an ``experts_I`` module along its leading
    (expert) axis: ``(.., experts_I, ..), [E, ...]`` -> ``E`` leaves
    ``(.., experts_I, "e", ..), [...]``."""
    for path, val in leaves:
        at = next((i for i, m in enumerate(path[:-1]) if _EXPERTS.match(m)),
                  None)
        if at is None:
            yield path, val
            continue
        for e, part in enumerate(np.asarray(val)):
            yield path[:at + 1] + (str(e),) + path[at + 1:], part


def from_jax_params(tree):
    """nps_tpu params tree -> an ordered ``state_dict`` of f32 CPU tensors."""
    if "params" in tree:
        tree = tree["params"]
    if set(tree) == {"inner"}:
        tree = tree["inner"]
    state = {}
    # the hidden convs of a BC encoder place its Linear in the Sequential
    n_hidden = len({m.group(3) for path, _ in _leaves(tree)
                    for m in [_BC_LAYER.search("/".join(path[:-1]))]
                    if m and m.group(3) is not None})
    for path, val in _split_experts(_leaves(tree)):
        arr = np.asarray(val, dtype=np.float32)
        *mods, leaf = path
        mod_path = "/".join(mods)
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim >= 3:
                nd = arr.ndim - 2
                order = ((nd, nd + 1) if _TRANSPOSE_CONV.search(mod_path)
                         else (nd + 1, nd))
                arr = np.transpose(arr, order + tuple(range(nd)))
        elif leaf == "scale":
            leaf = "weight"
        if mods:
            mod_path = _BC_LAYER.sub(
                lambda m: f"{m.group(1)}bc_encoder/bc_encoder/" + str(
                    0 if m.group(2) == "conv_in" else 2 * n_hidden + 3
                    if m.group(2) == "out" else 2 * int(m.group(3)) + 2),
                mod_path)
            mods = _DRN_CONV.sub(
                lambda m: f"{m.group(1)}processor_{m.group(2)}/layers_"
                          f"{2 * int(m.group(3))}", mod_path).split("/")
        key = ".".join([_INDEXED.sub(r"\1.\2", m) for m in mods] + [leaf])
        state[key] = torch.tensor(arr)
    return state
