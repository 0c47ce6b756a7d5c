"""Variable-length batching helpers (numpy, host-side; counterpart of
``nps_tpu/utils/collate.py``).

Capability parity with ``src/utils/collate_batch_helpers.py``: combine
elements of unequal time length by cropping to the min (random window) or
padding to the max (rounded to a time_window multiple), plus 0/1 validity
masks. These are the building blocks of the ``D.sim1d_var_t`` contract;
kept host-side so batches reach the device with static shapes.
"""

import numpy as np


def min_crop_starts(ts, tw, rng=None):
    """Per-element random start indices for a mode='min' crop over elements
    of time lengths ``ts``. Sampled ONCE per batch element and shared by
    every data role, so the state window, its numerical baseline, and any
    time-conditioning signal stay temporally ALIGNED — the reference
    samples independently per role (collate_batch_helpers.py:42 called
    separately per role), silently pairing windows from different times; a
    deliberate divergence."""
    shape_t = min(ts)
    shape_t -= shape_t % tw
    rand = (rng.integers if hasattr(rng, "integers")  # Generator API
            else (rng or np.random).randint)
    return np.array([int(rand(0, t - shape_t + 1)) for t in ts])


def collate_batch_sim(t_dim=1, mode="min", tw=25):
    """Returns a collate fn making all elements equal size along t_dim.

    mode='min' accepts ``starts`` (from :func:`min_crop_starts`) so every
    role crops the same window; clamped per element when a role is shorter
    than the role the starts were drawn for."""

    def collate_fn(batch_list, starts=None, shape_t=None):
        shapes = [x.shape for x in batch_list]
        ts = [s[t_dim] for s in shapes]
        if shape_t is None:
            # local extent; a multi-process loader passes the GLOBAL
            # min/max instead so every process collates to one shape
            if mode == "min":
                shape_t = min(ts)
                shape_t -= shape_t % tw
            elif mode == "max":
                shape_t = max(ts)
                if shape_t % tw:
                    shape_t += tw - shape_t % tw
            else:
                raise ValueError("Combining mode must be 'min' or 'max'")
        elif mode not in ("min", "max"):
            raise ValueError("Combining mode must be 'min' or 'max'")

        shape = list(shapes[0])
        shape[t_dim] = shape_t
        out = np.zeros((len(batch_list), *shape), dtype=batch_list[0].dtype)
        for i, el in enumerate(batch_list):
            t_len = el.shape[t_dim]
            if mode == "max":
                idx = (i,) + (slice(None),) * t_dim + (slice(0, t_len),)
                out[idx] = el
            else:
                if starts is not None:
                    start = min(int(starts[i]), t_len - shape_t)
                else:
                    start = np.random.randint(0, t_len - shape_t + 1)
                idx = (slice(None),) * t_dim + (slice(start, start + shape_t),)
                out[i] = el[idx]
        return out

    return collate_fn


def collate_data(t_dim=1, mode="min", return_lengths=True, tw=25):
    """Collate 5-tuples of (u_base, u, x, cond, t_cond) with variable t."""

    def collate(batch):
        collate_u = collate_batch_sim(t_dim=t_dim, mode=mode, tw=tw)
        assert len(batch[0]) == 5
        u_base = [x[0] for x in batch]
        u_super = [x[1] for x in batch]
        xs = [x[2] for x in batch]
        variables = [x[3] for x in batch]
        conditioning = [x[4] for x in batch]

        lengths = [x.shape[t_dim] for x in u_super]
        starts = (min_crop_starts(lengths, tw) if mode == "min" else None)
        u_base = (collate_u(u_base, starts=starts)
                  if sum(x.size for x in u_base) > 0
                  else np.stack(u_base))
        conditioning = (collate_u(conditioning, starts=starts)
                        if sum(x.size for x in conditioning) > 0
                        else np.stack(conditioning))
        u_super = collate_u(u_super, starts=starts)
        xs = np.stack(xs)
        variables = np.stack(variables)
        if return_lengths:
            return u_base, u_super, xs, variables, conditioning, lengths
        return u_base, u_super, xs, variables, conditioning

    return collate


def create_data_mask(data, t_lengths, t_dim=1):
    """0/1 validity mask matching ``data``'s shape along t_dim."""
    data = np.asarray(data)
    mask = np.zeros_like(data)
    for i in range(data.shape[0]):
        idx = ((i,) + (slice(None),) * t_dim + (slice(0, t_lengths[i]),) +
               (slice(None),) * (data.ndim - t_dim - 2))
        mask[idx] = 1
    return mask
