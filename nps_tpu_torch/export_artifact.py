"""Export a trained surrogate as a self-contained serving artifact.

Config + checkpoint in, one file out: ``torch.export`` of one bundled step
with the weights, the spectral weight packs and the position grid baked in,
and the rollout length in its header (see
``nps_tpu_torch.inference.SurrogateEngine.export_rollout``). It serves
without the model code, the config system or the checkpoint:
``nps_tpu_torch.inference.load_exported(path).rollout(u0, cond, sc)``.

    python -m nps_tpu_torch.export_artifact \\
        -C nps_tpu_torch/configs/train/cfg_twophase_ufno.py \\
        --checkpoint run_default.pt --out surrogate.npst --n-steps 19 \\
        [--static-batch 8] [--device cpu] [any --group.key config overrides]

The artifact is batch-polymorphic unless ``--static-batch`` pins it, and
loads on the device type it was exported on (default ``cuda``).
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-C", "--config", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="a port or PyTorch-reference state_dict (.pt)")
    ap.add_argument("--out", required=True, help="artifact path")
    ap.add_argument("--n-steps", type=int, required=True,
                    help="rollout steps baked into the artifact")
    ap.add_argument("--static-batch", type=int, default=None,
                    help="pin the batch dim instead of exporting symbolic")
    ap.add_argument("--device", default="cuda",
                    help="export (and serving) device: cuda or cpu")
    # the conditioning counts come from the dataset's sidecar in training;
    # the export runs dataset-free, so they are stated to rebuild the PDE
    # metadata the checkpoint was trained with
    ap.add_argument("--n-cond-static", type=int, default=0)
    ap.add_argument("--n-cond-dynamic", type=int, default=0)
    ap.add_argument("--n-cond-spatial", type=int, default=0)
    ns, overrides = ap.parse_known_args(argv)

    import numpy as np

    from nps_tpu_torch.configs.parse import parse_args
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    saved_argv = sys.argv
    try:
        sys.argv = ["export_artifact", *overrides]
        args = parse_args(ns.config)
    finally:
        sys.argv = saved_argv

    t_res, nx1, nx2 = args["trainer"]["base_resolution"]
    pde = PDE2D(tmin=0.0, tmax=1.0, nt=t_res, L1=1.0, L2=nx2 / nx1,
                nx1=nx1, nx2=nx2, x=None,
                name=args["dataset"].get("name", "pde"),
                n_cond_static=ns.n_cond_static,
                n_cond_dynamic=ns.n_cond_dynamic,
                n_cond_spatial=ns.n_cond_spatial)
    eng = SurrogateEngine.from_config(ns.config, checkpoint=ns.checkpoint,
                                      overrides=overrides, pde=pde,
                                      device=ns.device)
    tw = eng.tw
    b = ns.static_batch or 1
    num_c = int(args["model"].get("num_c", 1))
    sp = (nx1, nx2)
    n_cond = pde.n_cond_static + pde.n_cond_dynamic
    u0 = np.zeros((b, num_c, tw) + sp, np.float32)
    cond = np.zeros((b, n_cond), np.float32) if n_cond > 0 else None
    sc = (np.zeros((b, pde.n_cond_spatial) + sp, np.float32)
          if pde.n_cond_spatial > 0 else None)

    eng.export_rollout(ns.out, n_steps=ns.n_steps, example_u0=u0, cond=cond,
                       spatial_cond=sc, batch_poly=ns.static_batch is None)
    print(f"exported {ns.out}: n_steps={ns.n_steps} tw={tw} "
          f"batch={'symbolic' if ns.static_batch is None else b} "
          f"device={eng.device.type}")


if __name__ == "__main__":
    main()
