"""Where ``spectral_dw2d``'s time goes: variants of its kernel, timed at the
train step's shape on the GPU.

    python -m nps_tpu_torch.dw_probe [--out DIR]

Each variant is ``csrc/spectral_dft2d.cu`` from this checkout with one text
substitution, built by ``nvcc`` (all variants at once) into a temporary
directory and loaded with ``ctypes``; the C entry ``spectral_dw2d`` is then
timed (50 calls between two CUDA events, after a warm-up) on X [200, 16,
196] and G [200, 16, 192], the shapes a batch-16 train step gives it, and
checked against ``spectral_weight_grad``. The variants:

- ``kernel``: the source as it is;
- ``no_stores``: dW is not written (the sums and the loads only);
- ``no_sums``: the sums over the batch are skipped (the loads and the
  write-out only);
- ``streaming_stores``: the write-out with ``__stcs`` (evict-first);
- ``modes_5``, ``modes_25``: 5 or 25 modes per CTA instead of 10.

The two partial variants give wrong dW on purpose; their error is printed
but not held. Prints one JSON line with the card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from nps_tpu_torch import kernels
from nps_tpu_torch.ops import spectral as sp

STORE = ("out[((static_cast<int64_t>(part) * ci + ii) * co + oo) * nm + mc0 + mc] =\n"
         "          so[row * kDwLd + mc];")
GUARD = "if (mc < mcn && ii < ci && oo < co)"
SUMS = "const int sn = min(kDwSb, b - u % nsb * kDwSb);"
MODES = "constexpr int kDwModes = 10;"
VARIANTS = {
    "kernel": [],
    "no_stores": [(GUARD, GUARD[:-1] + " && b < 0)")],
    "no_sums": [(SUMS, "const int sn = 0;")],
    "streaming_stores": [(STORE, "__stcs(&" + STORE.replace(" =\n          ", ", ")[:-1]
                          + ");")],
    "modes_5": [(MODES, "constexpr int kDwModes = 5;")],
    "modes_25": [(MODES, "constexpr int kDwModes = 25;")],
}
M, B, CI, CO, M1, M2 = 200, 16, 196, 192, 10, 10


def build(tmp):
    """One shared library per variant; returns {name: path or None}."""
    src = (kernels.CSRC / "spectral_dft2d.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "common.cuh").write_text((kernels.CSRC / "common.cuh").read_text())
        (d / "k.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared", str(d / "k.cu"),
             "-o", str(d / "lib.so")],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return {name: (tmp / name / "lib.so" if p.wait() == 0 else None)
            for name, p in jobs.items()}


def event_ms(fn, calls=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dw_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    xr, xi = (torch.randn((M, B, CI), device="cuda", generator=g) for _ in range(2))
    gr, gi = (torch.randn((M, B, CO), device="cuda", generator=g) for _ in range(2))
    scale = sp.mode_scale(96, 64, M1, M2, "cuda")
    ref = sp.spectral_weight_grad(xr, xi, gr, gi, scale, M1)
    dw = [torch.empty_like(r) for r in ref]
    stream = torch.cuda.current_stream().cuda_stream
    rec = {"card": card, "shape": {"X": [M, B, CI], "G": [M, B, CO]},
           "timing": "50 calls between CUDA events", "variants": {}}
    with tempfile.TemporaryDirectory(prefix="dw_probe_") as tmp:
        for name, so in build(Path(tmp)).items():
            if so is None:
                rec["variants"][name] = "build failed"
                continue
            fn = ctypes.CDLL(str(so)).spectral_dw2d
            fn.argtypes = kernels.SIGNATURES["spectral_dw2d"]

            def call():
                kernels.check(fn(xr.data_ptr(), xi.data_ptr(), gr.data_ptr(),
                                 gi.data_ptr(), scale.data_ptr(), dw[0].data_ptr(),
                                 dw[1].data_ptr(), B, CI, CO, M1, M2, stream), name)

            call()
            torch.cuda.synchronize()
            err = max(float((a - r).abs().max() / r.abs().max())
                      for a, r in zip(dw, ref))
            rec["variants"][name] = {"ms": event_ms(call), "rel_err": err}
    rec["plain_ms"] = event_ms(
        lambda: sp.spectral_weight_grad(xr, xi, gr, gi, scale, M1), calls=20)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
