"""AWB-GCN's rebalancing applied to MoE expert parallelism (DESIGN.md §5),
through ``repro_torch`` (the counterpart of ``moe_rebalance.py``).

    PYTHONPATH=src python examples/moe_rebalance_torch.py [--device cpu]

Profiles a power-law router load (the MoE analogue of Fig. 5), applies the
AWB placement balancer — remote switching = placement swaps, evil-row
remapping = hot-expert replication — and runs a reduced qwen3-moe layer
with the placement tables, verifying the output is invariant (replicas
compute the same experts; the combine step is the adder tree). The layer
runs on the card by default and raises without one; ``--device cpu`` runs
it on the host.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core import moe_balance
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    e, devices = 128, 16
    load = moe_balance.zipf_expert_load(e, 200_000, alpha=1.0, seed=0)
    print(f"router load: top expert holds {load.max() / load.sum():.1%} of "
          f"tokens (power law, {e} experts)")

    static = moe_balance.static_placement(e, devices)
    print(f"static placement imbalance (max/mean device load): "
          f"{moe_balance.imbalance(moe_balance.device_loads(static, load)):.2f}x")
    for spare in (0, 16, 32):
        spd = (e + spare) // devices
        bal = moe_balance.balance_placement(load, devices,
                                            slots_per_device=spd)
        imb = moe_balance.imbalance(moe_balance.device_loads(bal, load))
        print(f"AWB placement, {spare:2d} spare slots: imbalance {imb:.3f}x "
              f"(max replicas {int(bal.replica_count.max())})")

    # run a reduced qwen3-moe MoE layer under the balanced placement
    cfg = configs.get_reduced_config("qwen3-moe-30b-a3b")
    mdims = moe_mod.MoEDims(cfg.d_model, 32, 8, 2, capacity_factor=64.0,
                            n_slots=12)
    params = moe_mod.init_moe_params(torch.Generator(device=dev).manual_seed(0),
                                     mdims, device=dev)
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    load8 = moe_balance.zipf_expert_load(8, 10_000, alpha=1.0, seed=2)
    placement = moe_balance.balance_placement(load8, 4, slots_per_device=3)
    tables = moe_mod.tables_from_placement(placement, device=dev)
    with torch.no_grad():
        out_bal, _ = moe_mod.moe_forward(params, mdims, x, placement=tables)
        out_ref, _ = moe_mod.moe_forward(params, mdims, x)
    err = float((out_bal - out_ref).abs().max())
    print(f"\nMoE layer output under AWB placement vs identity: "
          f"max err {err:.2e} (replicas are exact)")
    assert err < 1e-4
    print("OK")


if __name__ == "__main__":
    main()
