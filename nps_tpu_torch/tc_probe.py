"""Where the tensor-core DFT stages of K1's large-plane variant spend their
time: variants of ``dft_fwd_tc_kernel`` and ``dft_inv_tc_kernel``, timed
kernel by kernel at the ns512 call on the GPU.

    python -m nps_tpu_torch.tc_probe [--out FILE]

Each variant is ``csrc/spectral_dft2d.cu`` from this checkout with some
text substitutions, built by ``nvcc`` (all variants at once) into a
temporary directory and loaded with ``ctypes``; ``spectral_dft2d_fwd`` on
x [8, 132, 512, 512] -> 128 and ``spectral_dft2d_bwd`` on dy [8, 128, 512,
512] -> 132 (bf16, 20 x 20 modes) then run through it, and each kernel's
device time per call comes from torch.profiler (``trace_step.kernel_ms``).
The variants:

- ``kernel``: the source as it is;
- ``fwd_no_loads``: the forward stage reads neither x nor its y table
  from memory (the products on whatever the ring holds);
- ``fwd_no_products``: the forward stage's y-pass products replaced by
  one integer operation each (the loads only);
- ``fwd_no_x_pass``: the forward stage skips its x pass;
- ``inv_no_stores``: the inverse stage writes nothing;
- ``inv_no_products``: the inverse stage's column-pass products replaced
  by one operation each;
- ``inv_no_row_pass``: the inverse stage skips its row pass and the
  staging of Y (the column pass on zeros);
- ``no_early_launch``: the mixes do not let the inverse stage start early,
  so its duration no longer includes the mix it overlapped.

The partial variants give wrong results on purpose; their error is printed
but not held. Prints one JSON line with the card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import tempfile
import types
from pathlib import Path

import torch

from nps_tpu_torch import kernels
from nps_tpu_torch.ops import spectral as sp
from nps_tpu_torch.trace_step import kernel_ms

LOADS = ("    nps::mbar_expect_tx(bar, kTcXBytes + tc_table_bytes(MT));\n"
         "    nps::tma_load_3d(base, map, c * kTcKc, r0, plane, bar);\n"
         "    nps::bulk_load(base + kTcXBytes, tsrc, tc_table_bytes(MT), bar);")
Y_MMA = "for (int j = 0; j < 4; ++j) nps::mma_bf16(acc[i][j], regs(a), b[j]);"
X_PASS = "for (int t = warp; t < NT; t += kTcThreads / 32) {"
STORE = "if (r < rows_w && t0 + q < nt2)"
COL_MMA = ("nps::mma_bf16(acc[mt][j], ahi[mt][s], bhi);\n"
           "            nps::mma_bf16(acc[mt][j], ahi[mt][s], blo);\n"
           "            nps::mma_bf16(acc[mt][j], alo[mt][s], bhi);")
ROW_PASS = "for (int s = 0; active && s < KS1; ++s) {"
Y_STAGE = ("#pragma unroll 4\n"
           "  for (int i = threadIdx.x; i < K * m2; i += kTcThreads) {")
EARLY = "nps::launch_dependents();         // the inverse may stage its tables"
VARIANTS = {
    "kernel": [],
    "fwd_no_loads": [(LOADS, "    nps::mbar_expect_tx(bar, 0);\n"
                              "    (void)base;\n    (void)tsrc;")],
    "fwd_no_products": [(Y_MMA, Y_MMA.replace(
        "nps::mma_bf16(acc[i][j], regs(a), b[j]);",
        "acc[i][j][0] += __uint_as_float(a.x ^ b[j][0]);"))],
    "fwd_no_x_pass": [(X_PASS, X_PASS.replace("t < NT", "t < NT && n2 < 0"))],
    "inv_no_stores": [(STORE, STORE[:-1] + " && scale < 0.f)")],
    "inv_no_products": [(COL_MMA, "acc[mt][j][0] += __uint_as_float("
                                  "bhi[0] ^ blo[1] ^ ahi[mt][s][0]);")],
    "inv_no_row_pass": [(ROW_PASS, ROW_PASS.replace("active &&", "n2 < 0 &&")),
                        (Y_STAGE, Y_STAGE.replace("i < K * m2", "i < K * m2 && n2 < 0"))],
    "no_early_launch": [(EARLY, "// (no early launch)")],
}
B, CI, CO, N, MODES = 8, 132, 128, 512, (20, 20)


def build(tmp):
    """One shared library per variant; returns {name: path or None}."""
    src = (kernels.CSRC / "spectral_dft2d.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            count = 2 if old == EARLY else 1   # the mix and the adjoint mix
            if text.count(old) != count:
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


def _rel(a, ref):
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tc_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, CI, N, N), device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn((B, CO, N, N), device="cuda", generator=g).to(torch.bfloat16)
    ws = [torch.rand((2, CI, CO) + MODES, device="cuda", generator=g) / (CI * CO)
          for _ in range(2)]
    wp = sp.pack_weights_2d(ws)
    ref_y = sp.spectral_conv_2d_plain(x, ws, MODES)
    ref_dx = sp.spectral_dft2d_bwd_plain(dy, wp, MODES)[0]
    rec = {"card": card, "shape": {"x": list(x.shape), "dy": list(dy.shape),
                                   "modes": list(MODES)},
           "timing": "device ms per call by kernel, torch.profiler, 3 calls",
           "variants": {}}
    saved = kernels._lib
    try:
        with tempfile.TemporaryDirectory(prefix="tc_probe_") as tmp:
            for name, so in build(Path(tmp)).items():
                if so is None:
                    rec["variants"][name] = "build failed"
                    continue
                lib = ctypes.CDLL(str(so))
                fns = {}
                for entry in ("spectral_dft2d_fwd_large", "spectral_dft2d_bwd_large"):
                    fn = getattr(lib, entry)
                    fn.argtypes, fn.restype = kernels.SIGNATURES[entry], ctypes.c_int
                    fns[entry] = fn
                kernels._lib = types.SimpleNamespace(**fns)
                fwd = (lambda: sp.spectral_dft2d_fwd(x, wp, MODES))
                bwd = (lambda: sp.spectral_dft2d_bwd(dy, wp, MODES))
                (f_ms, f_span), (b_ms, b_span) = kernel_ms(fwd), kernel_ms(bwd)
                rec["variants"][name] = {
                    "fwd_kernel_ms": f_ms, "fwd_span_ms": f_span,
                    "bwd_kernel_ms": b_ms, "bwd_span_ms": b_span,
                    "rel_err_y": _rel(fwd(), ref_y), "rel_err_dx": _rel(bwd()[0], ref_dx)}
    finally:
        kernels._lib = saved
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
