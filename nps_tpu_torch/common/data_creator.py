"""Time-window slicing and grid-graph construction (counterpart of
``nps_tpu/common/data_creator.py``; host numpy, the port's own copy).

- :func:`create_data`: per-element input windows [step-tw, step) and label
  windows [step, step+tw);
- :meth:`DataCreator.create_graph` / :meth:`DataCreator.create_next_graph`:
  a grid batch as a :class:`~nps_tpu_torch.common.graph.GridGraph`. The edge
  set is built once per grid in numpy (all batch elements share the regular
  grid) and tiled; the node tensors are plain reshapes.
"""

import hashlib

import numpy as np

from nps_tpu_torch.common.graph import (
    GridGraph, flat_positions, grid_edges, grid_to_nodes, tile_edges)


class DataCreator:
    def __init__(self, pde, neighbors=2, time_window=5, t_resolution=250,
                 x_resolution=100):
        self.pde = pde
        self.n = int(neighbors)
        self.tw = int(time_window)
        self.t_res = int(t_resolution)
        self.x_res = x_resolution
        self._edge_cache = {}

    def create_data(self, datapoints, steps, mode="both"):
        return create_data(datapoints, steps, self.tw, mode)

    def grid_edge_index(self, x_grid, batch_size):
        """The batch's edge set for the dataset grid, built once and tiled
        with node offsets."""
        x0 = np.asarray(x_grid)
        # keyed on the grid's content, not just its shape: a rescaled
        # same-shape grid changes the radius rule's edge set
        key = (x0.shape, batch_size,
               hashlib.sha1(np.ascontiguousarray(x0)).hexdigest())
        if key not in self._edge_cache:
            single = grid_edges(self.pde, x0, self.n)
            n_nodes = flat_positions(x0).shape[0]
            self._edge_cache[key] = tile_edges(single, n_nodes, batch_size)
        return self._edge_cache[key]

    def create_graph(self, data, labels, x, conditioning, steps):
        """Grid batch -> :class:`GridGraph`: node features are the flattened
        input windows, ``pos`` carries (t[step], x...), edges follow the
        PDE-keyed radius/knn rules."""
        data = np.asarray(data)
        labels = np.asarray(labels)
        x = np.asarray(x)
        b = data.shape[0]
        x0 = x[0]  # all elements share the grid
        pos_x = flat_positions(x0)
        nx = pos_x.shape[0]

        t = np.linspace(self.pde.tmin, self.pde.tmax, self.pde.nt,
                        dtype=np.float32)
        t_pos = np.repeat(t[np.asarray(steps)], nx)[:, None]
        pos = np.concatenate([t_pos, np.tile(pos_x, (b, 1))], axis=1)
        batch = np.repeat(np.arange(b, dtype=np.int32), nx)

        cond = None
        if conditioning is not None and np.asarray(conditioning).size > 0:
            cond = np.asarray(conditioning)[batch]

        return GridGraph(
            nodes=grid_to_nodes(data), y=grid_to_nodes(labels),
            edge_index=self.grid_edge_index(x0, b),
            pos=pos.astype(np.float32), batch=batch, cond=cond)

    def create_next_graph(self, graph, pred, labels, steps):
        """Roll the node window forward for pushforward unrolling: the
        predictions become the inputs, labels and t advance. ``nodes`` and
        ``pred`` may be numpy arrays or torch tensors; ``steps`` are host
        ints (they index the numpy time grid)."""
        if isinstance(graph.nodes, np.ndarray):
            nodes = np.concatenate([graph.nodes, pred], axis=2)[:, :, self.tw:]
        else:
            import torch

            nodes = torch.cat([graph.nodes, pred], dim=2)[:, :, self.tw:]
        nx = graph.pos.shape[0] // len(steps)
        t = np.linspace(self.pde.tmin, self.pde.tmax, self.pde.nt,
                        dtype=np.float32)
        t_pos = np.repeat(t[np.asarray(steps)], nx)[:, None]
        if isinstance(graph.pos, np.ndarray):
            pos = np.concatenate([t_pos.astype(graph.pos.dtype),
                                  graph.pos[:, 1:]], axis=1)
        else:
            import torch

            pos = torch.cat([torch.as_tensor(t_pos, dtype=graph.pos.dtype,
                                             device=graph.pos.device),
                             graph.pos[:, 1:]], dim=1)
        return graph._replace(nodes=nodes, y=grid_to_nodes(labels), pos=pos)


def create_data(datapoints, steps, tw, mode="both"):
    """datapoints: [b, c, t, *sp]; steps: per-element start step list."""
    assert mode in ("data", "labels", "both")
    data, labels = [], []
    for dp, step in zip(datapoints, steps):
        assert step - tw >= 0 and step + tw <= dp.shape[1], \
            "this step - time window combination is not valid"
        if mode in ("data", "both"):
            data.append(dp[:, step - tw:step][None])
        if mode in ("labels", "both"):
            labels.append(dp[:, step:step + tw][None])
    if mode == "data":
        return np.concatenate(data, axis=0)
    if mode == "labels":
        return np.concatenate(labels, axis=0)
    return np.concatenate(data, axis=0), np.concatenate(labels, axis=0)
