"""Where a bf16 serving step of ``cfg_ns512_ufno`` departs from the f32 one,
module by module, on one NVIDIA GPU.

    python -m nps_tpu_torch.bf16_probe [--seed 0] [--batch 2]

Builds the config at full width twice on the card, in bf16 and in f32, with
the same random weights from the seed, runs one serving step of each with
forward hooks on the modules down to three levels (the encoder, each U-FNO
block's FNO layer and U-Net, the decoder and their children), and prints
one JSON line per input: for each module the largest deviation of the bf16
output from the f32 one over the f32 output's largest value, and the nRMSE;
then the step's. The inputs: the first windows of a split of 2 simulations
from the port's generator at 512x512, read through ``PDE2DDataset`` (the
data ``chip_smoke.py`` serves), and uniform random windows at 64x64 (16
modes, as a 64-point row holds) and 512x512. TF32 stays off. It tells the
bf16 path's own rounding from a fault: a faulty module departs from its
input's deviation, a rounding one does not.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile

import numpy as np
import torch

from nps_tpu_torch.data.pde2d import PDE2DDataset
from nps_tpu_torch.data.synthetic import generate
from nps_tpu_torch.inference import SurrogateEngine
from nps_tpu_torch.pde import PDE2D

CFG = "nps_tpu_torch/configs/train/cfg_ns512_ufno.py"
TW = 25


def _outputs(eng, u0, cond, sc, names):
    """One step of ``eng`` with each named module's output kept (f32, on
    the device): (step, {name: output})."""
    outs, hooks = {}, []
    for name, m in eng.model.named_modules():
        if name in names:
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, name=name: outs.__setitem__(
                    name, out.detach().float().clone())))
    try:
        return eng.step(u0, cond=cond, spatial_cond=sc), outs
    finally:
        for h in hooks:
            h.remove()


def _dev(a, ref):
    a, ref = torch.as_tensor(a).float(), torch.as_tensor(ref).float()
    d = a - ref
    return {"max_rel": float(d.abs().max() / ref.abs().max()),
            "nrmse": float(d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())}


def compare(pde, u0, cond, sc, seed, overrides=()):
    with contextlib.redirect_stdout(sys.stderr):   # the config's report
        engines = {dt: SurrogateEngine.from_config(
            CFG, pde=pde, overrides=list(overrides), compute_dtype=dt)
            for dt in ("bfloat16", "float32")}
    engines["bfloat16"].init_params(seed=seed)
    engines["float32"].model.load_state_dict(
        engines["bfloat16"].model.state_dict())
    names = [n for n, _ in engines["float32"].model.named_modules()
             if n and n.count(".") <= 3]
    step32, out32 = _outputs(engines["float32"], u0, cond, sc, names)
    step16, out16 = _outputs(engines["bfloat16"], u0, cond, sc, names)
    modules = {n: dict(_dev(out16[n], out32[n]), shape=list(out32[n].shape))
               for n in names if n in out16 and n in out32
               and out16[n].shape == out32[n].shape}
    return {"step": _dev(step16, step32), "modules": modules}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    b, rng = args.batch, np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="bf16_probe_") as tmp:
        generate(f"{tmp}/ns512", n_sims=b, n_channels=1, nt=101, nx1=512,
                 nx2=512, seed=args.seed)
        ds = PDE2DDataset(tmp, "ns512", "memmap", "snapshots",
                          conditioning="conditioning",
                          spatial_conditioning="spatial_conditioning",
                          c_filter=[0], split_file="split", name="ns512")
        items = [ds.dataset[i] for i in range(b)]
        batch = [np.stack([np.asarray(it[k]) for it in items])
                 for k in (1, 3, 5)]
        batch[0] = np.ascontiguousarray(batch[0][:, :, :TW])
        rec = compare(ds.pde, *batch, args.seed)
    print(json.dumps({"card": card, "input": "generated 512x512",
                      "batch": b, **rec}), flush=True)
    for n, modes in ((64, 16), (512, 20)):
        pde = PDE2D(tmin=0.0, tmax=1.0, nt=101, L1=1.0, L2=1.0, nx1=n,
                    nx2=n, x=None, name="ns512", n_cond_static=2,
                    n_cond_spatial=2)
        u0 = (0.1 + 0.8 * rng.random((b, 1, TW, n, n))).astype(np.float32)
        cond = rng.random((b, 2)).astype(np.float32)
        sc = (rng.random((b, 2, n, n)) > 0.8).astype(np.float32)
        rec = compare(pde, u0, cond, sc, args.seed,
                      [f"--model.fno_modes={modes}"])
        print(json.dumps({"card": card, "input": f"random {n}x{n}",
                          "batch": b, **rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
