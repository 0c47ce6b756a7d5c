"""Physics step post-processing: BC extraction/injection and min clipping
(counterpart of ``nps_tpu/utils/process_output.py``), as tensor functions
that return new tensors.

Only DIV1D-named PDEs have active logic; every other PDE (the twophase
datasets included) passes through unchanged with ``bc=None``.
``process_settings`` can force ``set_bc`` / ``set_min`` off. Layout
``[b, c, tw, *spatial]``.
"""

import torch

from nps_tpu_torch.common.interfaces import M


def process_step(pde, model_interface, sim_prev, gtbc_prev, gtbc_next,
                 get_bc=True, set_bc=True, set_min=True, process_settings=None):
    """Returns (sim, bc)."""
    if process_settings:
        if "set_bc" in process_settings:
            set_bc = set_bc and process_settings["set_bc"]
        if "set_min" in process_settings:
            set_min = set_min and process_settings["set_min"]

    # set_bc applies only to AR_TB, and the GNN BC signal never references
    # the model output, as in the reference
    if f"{pde}" == "DIV1D" and model_interface in (M.AR_TB, M.AR_TB_GNN):
        if set_bc and model_interface == M.AR_TB:
            sim_prev = set_bc_1d(0, 0, sim_prev, gtbc_prev)
        if set_min:
            mu_ne, sd_ne = pde.var_mean_sd[0]
            mu_te, sd_te = pde.var_mean_sd[2]
            mu_nn, sd_nn = pde.var_mean_sd[3]
            min_values = [(0.1 - mu_ne) / sd_ne,
                          (0.1 - mu_te) / sd_te,
                          (0.1 - mu_nn) / sd_nn]
            sim_prev = set_min_values([0, 2, 3], min_values, sim_prev)
        bc = None
        if get_bc:
            if model_interface == M.AR_TB:
                bc = extract_bc_1d(0, 0, sim_prev=sim_prev,
                                   gtbc_prev=gtbc_prev, gtbc_next=gtbc_next,
                                   mode=pde.bc_mode)
            else:
                bc = extract_bc_1d_simple(0, 0, gtbc_prev=gtbc_prev,
                                          gtbc_next=gtbc_next,
                                          mode=pde.bc_mode)
        return sim_prev, bc
    return sim_prev, None


def set_bc_1d(bc_dim, bc_x, sim, gtbc):
    """Overwrite boundary values of ``sim`` [b, c, tw, nx] with the ground
    truth's; bc_x in {0, -1}."""
    assert bc_x in (0, -1)
    sim = sim.clone()
    sim[:, bc_dim, :, bc_x] = gtbc[:, bc_dim, :, bc_x]
    return sim


def set_min_values(dims, min_values, sim):
    """Clamp the given channels from below."""
    sim = sim.clone()
    for d, mv in zip(dims, min_values):
        sim[:, d] = torch.clamp(sim[:, d], min=mv)
    return sim


def extract_bc_1d(bc_dim, bc_x, sim_prev, gtbc_prev, gtbc_next, mode="delta"):
    """BC signal [b, n_bc, tw] from the simulated and ground-truth
    boundaries."""
    assert bc_x in (0, -1)
    tw = sim_prev.shape[2]
    boundary_prev = sim_prev[:, bc_dim, :, bc_x]   # [b, tw]
    bc_prev = gtbc_prev[:, bc_dim, :, bc_x]
    bc_next = gtbc_next[:, bc_dim, :, bc_x]
    boundary_last = boundary_prev[:, -1:].expand(-1, tw)
    dif_new = bc_next - boundary_last
    dif_prev = bc_prev - boundary_last
    if mode == "delta":
        return torch.stack([dif_new, dif_prev], dim=1)
    if mode == "all_fixed_bc":
        return torch.stack([boundary_prev, bc_next, dif_new], dim=1)
    if mode == "all":
        return torch.stack([boundary_prev, bc_prev, bc_next, dif_new,
                            dif_prev], dim=1)
    if mode == "simple":
        return torch.stack([bc_prev, bc_next], dim=1)
    raise ValueError("Incorrect BC mode")


def extract_bc_1d_simple(bc_dim, bc_x, gtbc_prev, gtbc_next, mode="delta"):
    """BC extraction that does not reference the model output."""
    assert bc_x in (0, -1)
    tw = gtbc_prev.shape[2]
    bc_prev = gtbc_prev[:, bc_dim, :, bc_x]
    bc_next = gtbc_next[:, bc_dim, :, bc_x]
    boundary_last = bc_prev[:, -1:].expand(-1, tw)
    dif_new = bc_next - boundary_last
    dif_prev = bc_prev - boundary_last
    if mode == "delta":
        return torch.stack([dif_new, dif_prev], dim=1)
    if mode == "simple":
        return torch.stack([bc_prev, bc_next], dim=1)
    raise ValueError("Incorrect BC mode")
