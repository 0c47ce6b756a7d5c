"""Static-shape grid graphs for the MP-GNN (counterpart of
``nps_tpu/common/graph.py``; the port keeps its own copy of these host numpy
functions, so its edge sets equal the JAX package's exactly).

Every batch element shares the same regular grid, so the edge set is built
once per (grid, rule) on the host in numpy and tiled across the batch with
node offsets. :class:`GridGraph` is a flat NamedTuple of node-space tensors.

Edge convention: ``edge_index[0] = senders (source j)``,
``edge_index[1] = receivers (target i)``: messages flow j -> i. Edges are
sorted by receiver. :func:`grid_to_nodes` / :func:`nodes_to_grid` take numpy
arrays or torch tensors; :func:`structure_on` and :func:`apply_on_grid` are
the trainer's and the engine's way from a grid window through a node-space
model and back.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class GridGraph(NamedTuple):
    """A batch of identical regular-grid graphs, flattened to node space
    (numpy arrays on the host, torch tensors at the model).

    nodes:      [N, c, tw]   node features (N = batch_size * n_nodes)
    y:          [N, c, tw]   label window (or None outside training)
    edge_index: [2, E] int32 senders / receivers (static shape)
    pos:        [N, 1+nd]    (t, x1..xnd) node coordinates
    batch:      [N] int32    batch-element id per node
    cond:       [N, n_cond]  per-node static conditioning (or None)
    """

    nodes: Any
    edge_index: Any
    pos: Any
    batch: Any
    y: Optional[Any] = None
    cond: Optional[Any] = None


# ----------------------------------------------------------------------
# host-side (numpy) edge builders
# ----------------------------------------------------------------------
def _d2_rows(pos, lo, hi):
    """Squared distances from rows [lo, hi) to all points, matmul form
    (|a|^2 + |b|^2 - 2ab^T) — no [rows, n, nd] broadcast intermediate."""
    sq = np.sum(pos * pos, axis=1)
    d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (pos[lo:hi] @ pos.T)
    return np.maximum(d2, 0.0)


def _pairwise_edges(pos, mask_fn, loop=False, chunk=2048):
    """All (j -> i) pairs of one point set where ``mask_fn(d2)[i, j]``.

    Row-chunked so the distance matrix never materializes whole (a 128^2
    grid is 16k nodes -> 2 GB dense f64; chunks cap the peak at the
    [chunk, n] block, ~256 MB)."""
    pos = np.asarray(pos, np.float64)
    if pos.ndim == 1:
        pos = pos[:, None]
    n = pos.shape[0]
    sends, recvs = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d2 = _d2_rows(pos, lo, hi)
        if not loop:
            # exclude self BEFORE masking: a capped mask (radius_graph's
            # max_num_neighbors cumsum) must not spend a slot on the
            # zero-distance self column
            d2[np.arange(hi - lo), np.arange(lo, hi)] = np.inf
        adj = mask_fn(d2)
        recv, send = np.nonzero(adj)  # row i receives from column j
        sends.append(send)
        recvs.append(recv + lo)
    return np.stack([np.concatenate(sends),
                     np.concatenate(recvs)]).astype(np.int32)


def radius_graph(pos, r, batch=None, loop=False, max_num_neighbors=None):
    """Edges j -> i for all pairs with ``|x_i - x_j| <= r``.

    Parity with torch_cluster's ``radius_graph`` as used by the reference
    (``data_creator.py:124-136``). ``batch`` restricts edges to within each
    batch segment. Callers are expected to pad ``r`` by a small epsilon —
    see :func:`grid_edges` for why.

    ``max_num_neighbors``: torch_cluster caps each node at 32 in-radius
    neighbors by default (keeping the first 32 by node index, not the
    nearest). We default to uncapped — exact ball graphs — because for the
    regular grids the reference actually runs (neighbors<=2) the cap never
    binds. Pass 32 for strict torch_cluster parity on denser point sets.
    """
    def mask(d2):
        adj = d2 <= float(r) ** 2
        if max_num_neighbors is not None:
            adj &= np.cumsum(adj, axis=1) <= int(max_num_neighbors)
        return adj

    return _batched(pos, batch, lambda p: _pairwise_edges(p, mask, loop=loop))


def knn_graph(pos, k, batch=None, loop=False):
    """Edges j -> i for the k nearest neighbors j of each node i."""

    def one(p, chunk=2048):
        p = np.asarray(p, np.float64)
        if p.ndim == 1:
            p = p[:, None]
        n = p.shape[0]
        kk = min(int(k), n - (0 if loop else 1))
        sends, recvs = [], []
        for lo in range(0, n, chunk):  # row-chunked like _pairwise_edges
            hi = min(lo + chunk, n)
            d2 = _d2_rows(p, lo, hi)
            if not loop:
                d2[np.arange(hi - lo), np.arange(lo, hi)] = np.inf
            nbr = np.argpartition(d2, kk - 1, axis=1)[:, :kk]  # [rows, k]
            recvs.append(np.repeat(np.arange(lo, hi), kk))
            sends.append(nbr.reshape(-1))
        return np.stack([np.concatenate(sends),
                         np.concatenate(recvs)]).astype(np.int32)

    return _batched(pos, batch, one)


def _batched(pos, batch, one_fn):
    pos = np.asarray(pos)
    if batch is None:
        edges = one_fn(pos)
    else:
        batch = np.asarray(batch).astype(np.int64)
        parts = []
        for b in np.unique(batch):
            idx = np.nonzero(batch == b)[0]
            e = one_fn(pos[idx])
            parts.append(idx[e])  # contiguous segments -> idx[e] = e + off
        edges = np.concatenate(parts, axis=1) if parts else \
            np.zeros((2, 0), np.int32)
    order = np.argsort(edges[1], kind="stable")  # sort by receiver
    return edges[:, order].astype(np.int32)


def tile_edges(edge_index, n_nodes, batch_size):
    """Replicate one element's edge set across a batch with node offsets.

    All batch elements share the grid, so the per-batch edge build
    collapses to one build + offsets.
    """
    edge_index = np.asarray(edge_index, np.int32)
    offs = (np.arange(batch_size, dtype=np.int32) * n_nodes)[None, :, None]
    return (edge_index[:, None, :] + offs).reshape(2, -1)


# ----------------------------------------------------------------------
# grid <-> node-space layout converters (numpy arrays or torch tensors)
# ----------------------------------------------------------------------
def _permute(a, axes):
    return a.permute(*axes) if hasattr(a, "permute") else a.transpose(axes)


def grid_to_nodes(u):
    """[b, c, tw, *sp] -> [b*nx, c, tw] (row-major spatial flatten):
    element-major, then row-major grid, the reference's
    ``flatten(2).permute(2, 0, 1)`` node order."""
    b, c, tw = u.shape[:3]
    flat = u.reshape(b, c, tw, -1)             # [b, c, tw, nx]
    return _permute(flat, (0, 3, 1, 2)).reshape(-1, c, tw)


def nodes_to_grid(nodes, batch_size, spatial_shape):
    """[b*nx, c, tw] -> [b, c, tw, *sp], the inverse of
    :func:`grid_to_nodes`."""
    c, tw = nodes.shape[1:]
    h = nodes.reshape(batch_size, -1, c, tw)    # [b, nx, c, tw]
    return _permute(h, (0, 2, 3, 1)).reshape(
        (batch_size, c, tw) + tuple(spatial_shape))


def flat_positions(x_grid):
    """One element's coordinate grid -> [nx, nd] flat positions.

    ``x_grid``: [*sp] (1D) or [*sp, nd] (channels-last grid, the dataset
    layout).
    """
    x = np.asarray(x_grid)
    if x.ndim == 1:
        return x[:, None].astype(np.float32)
    return x.reshape(-1, x.shape[-1]).astype(np.float32)


def build_static_structure(pde, x_grid, neighbors, batch_size,
                           edge_index=None):
    """Host-side (edges, pos, batch, grid_meta) for the GNN paths.

    Built once per (grid, batch size) and reused by the trainer's and the
    engine's steps, in place of a per-batch ``create_graph``. The pos time
    column is fixed at 0 (the model drops it).

    ``grid_meta`` is the static structure for the shifted-grid message
    passing fast path (``models/gnn.py``): ``(spatial_shape, offsets,
    deltas)`` where every edge of the set is a constant integer grid
    offset. It is only emitted when that equivalence is PROVEN (the
    offset-derived edge set is compared against the actual one); knn
    graphs and irregular grids get ``None`` and the gather path."""
    x0 = np.asarray(x_grid)
    pos_x = flat_positions(x0)
    nx = pos_x.shape[0]
    if edge_index is None:
        edge_index = grid_edges(pde, x0, neighbors)
    edges = tile_edges(edge_index, nx, batch_size)
    batch = np.repeat(np.arange(batch_size, dtype=np.int32), nx)
    pos = np.concatenate(
        [np.zeros((batch_size * nx, 1), np.float32),
         np.tile(pos_x, (batch_size, 1))], axis=1)
    grid_meta = grid_offset_structure(x0, edge_index)
    return edges, pos, batch, grid_meta


def grid_offset_structure(x_grid, edge_index):
    """Recognize a regular-grid edge set as constant integer offsets.

    Returns ``(spatial_shape, offsets, deltas)`` — offsets as integer
    tuples per spatial dim, deltas as the constant ``pos_recv - pos_send``
    float tuples (same units as the graph pos) — or ``None`` when the edge
    set is not offset-structured (knn ties, irregular spacing).
    """
    x0 = np.asarray(x_grid)
    sp = tuple(x0.shape[:-1]) if x0.ndim > 1 else (x0.shape[0],)
    nd = len(sp)
    pos = flat_positions(x0)
    if pos.shape[0] != int(np.prod(sp)):
        return None
    send, recv = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    # multi-index of every node in raster order
    mi = np.stack(np.unravel_index(np.arange(pos.shape[0]), sp), axis=1)
    diff = mi[send] - mi[recv]                      # sender = recv + offset
    offsets = np.unique(diff, axis=0)
    # rebuild the edge set from the offsets and require exact equality
    have = set(zip(send.tolist(), recv.tolist()))
    want = set()
    grids = np.stack(np.meshgrid(*[np.arange(s) for s in sp],
                                 indexing="ij"), axis=-1).reshape(-1, nd)
    for off in offsets:
        si = grids + off
        ok = np.all((si >= 0) & (si < np.asarray(sp)), axis=1)
        s_flat = np.ravel_multi_index(tuple(si[ok].T), sp)
        r_flat = np.ravel_multi_index(tuple(grids[ok].T), sp)
        want.update(zip(s_flat.tolist(), r_flat.tolist()))
    if want != have:
        return None
    # deltas: pos_recv - pos_send must be constant per offset — verify on
    # one representative edge per offset and on spacing regularity
    deltas = []
    for off in offsets:
        sel = np.all(diff == off, axis=1)
        d = pos[recv[sel]] - pos[send[sel]]
        if not np.allclose(d, d[0], atol=1e-5):
            return None
        deltas.append(tuple(float(v) for v in d[0]))
    offsets = tuple(tuple(int(v) for v in off) for off in offsets)
    return sp, offsets, tuple(deltas)


def grid_edges(pde, x_grid, neighbors):
    """Build one element's edge set per the reference's PDE-keyed rules
    (``data_creator.py:124-138``): CE/burgers/DIV1D -> radius ``n*dx``;
    WE -> knn ``k=n``; NS -> radius ``n*sqrt(dx1^2+dx2^2)``.

    Extension over the reference (which raises for unknown names): any other
    PDE falls back to the dimensionality-matched radius rule, so the GNN
    path also runs on e.g. the twophase dataset.

    Deliberate divergence: the reference pads only the 1D radii with +1e-4
    (``data_creator.py:126,135``) and leaves NS unpadded, so whether the
    exact-boundary diagonal neighbors (distance == n*hypot(dx1,dx2)) make
    it into the NS edge set depends on float rounding of the coordinates —
    nondeterministic across grid sizes. The rule's intent is clearly to
    include them (they define the radius), so the epsilon is applied in 2D
    too, making the edge set deterministic."""
    pos = flat_positions(x_grid)
    name = f"{pde}"
    n = int(neighbors)
    if name == "WE":
        return knn_graph(pos, n)
    if name in ("NS",) or (name not in ("CE", "burgers", "DIV1D")
                           and pos.shape[1] == 2):
        r = n * float(np.hypot(pde.dx1, pde.dx2))
        return radius_graph(pos, r + 1e-4)
    dx = float(pos[1, 0] - pos[0, 0])
    return radius_graph(pos, n * dx + 1e-4)


def structure_on(device, pde, x_grid, neighbors, batch_size):
    """:func:`build_static_structure` with the edges, node positions and
    batch ids as tensors on ``device`` (indices as int64); ``grid_meta``
    stays a host value. Normal tensors even under inference mode, so a
    later autograd pass can use them."""
    edges, pos, batch, meta = build_static_structure(pde, x_grid, neighbors,
                                                     batch_size)
    with torch.inference_mode(False):
        return (torch.as_tensor(edges, dtype=torch.long, device=device),
                torch.as_tensor(pos, device=device),
                torch.as_tensor(batch, dtype=torch.long, device=device),
                meta)


def apply_on_grid(model, u, structure, **kwargs):
    """Apply a node-space model to the grid window u [b, c, tw, *sp] over
    ``structure`` (:func:`structure_on` at batch b): grid -> nodes ->
    ``model(graph, grid_meta=..., **kwargs)`` -> grid."""
    b, sp = u.shape[0], tuple(u.shape[3:])
    edges, pos, batch, meta = structure
    graph = GridGraph(nodes=grid_to_nodes(u), edge_index=edges, pos=pos,
                      batch=batch)
    return nodes_to_grid(model(graph, grid_meta=meta, **kwargs), b, sp)
