"""Provision DCIM macros for real LM architectures + execute a model
layer through the generated macro's numerics, on the PyTorch port.

    PYTHONPATH=src python examples/torch_dcim_for_llm.py               # one card
    PYTHONPATH=src python examples/torch_dcim_for_llm.py --device cpu

The port of ``examples/dcim_for_llm.py``, at its sizes: the explorer
sizes macros for an architecture's GEMM workloads (the ``dominance``
kernel on the card), and the DCIM integer matmul (the ``dcim_mvm``
kernel on the card) executes a real projection layer with INT8 DCIM
numerics.  ``--device cuda`` (the default) raises without a card.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import NSGA2Config
from repro_torch.core.precision import get as get_precision
from repro_torch.dcimmap import extract, plan
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.sim import DCIMMacroSim

CFG = NSGA2Config(pop_size=64, generations=32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    print("=== GEMM workloads per architecture ===")
    workloads = {}
    for arch in ("qwen2.5-3b", "falcon-mamba-7b", "deepseek-v3-671b"):
        wl = extract(configs.get_config(arch))
        workloads[arch] = {"gemm_classes": len(wl.gemms), "weights": wl.total_weights(),
                           "macs_per_token": wl.macs_per_token(),
                           "unmappable": list(wl.unmappable)}
        print(f"  {arch}: {len(wl.gemms)} GEMM classes, "
              f"{wl.total_weights() / 1e9:.2f}B weights, "
              f"{wl.macs_per_token() / 1e9:.2f} GMAC/token")
        for u in wl.unmappable:
            print(f"     not DCIM-mappable: {u}")

    print("\n=== INT8 macro provisioning (explorer-driven) ===")
    plans = {}
    for arch in ("qwen2.5-3b", "phi4-mini-3.8b"):
        p = plan(arch, precision="int8", w_store=65536, cfg_nsga=CFG, device=dev)
        plans[arch] = p.summary()
        print("  " + p.summary())
        print(f"     chosen macro: {p.point.summary()}")

    print("\n=== Execute a real projection through DCIM numerics ===")
    cfg = configs.get_smoke_config("qwen2.5-3b")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    w = params["blocks"][0]["mixer"]["wq"]["w"][0]          # (D, H*hd)
    x = torch.randn((8, w.shape[0]), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    sim = DCIMMacroSim(get_precision("int8"), N=64, H=64, L=8, k=4)
    y_dcim = sim.mvm(x, w.to(torch.float32))
    y_ref = x @ w.to(torch.float32)
    y_dcim, y_ref = y_dcim.cpu().numpy(), y_ref.cpu().numpy()
    rel = float(np.median(np.abs(y_dcim - y_ref) / np.maximum(np.abs(y_ref), 1e-3)))
    acct = sim.account(8, w.shape[0], w.shape[1])
    print(f"  wq through INT8 DCIM: median rel err {rel:.3%} "
          f"(quantization-only; bit-serial MAC is exact)")
    print(f"  macro accounting: {acct['cycles']} cycles, "
          f"{acct['latency_us']:.1f} us, {acct['energy_uJ']:.2f} uJ")
    return {"workloads": workloads, "plans": plans, "median_rel_err": rel,
            "cycles": acct["cycles"]}


if __name__ == "__main__":
    main()
