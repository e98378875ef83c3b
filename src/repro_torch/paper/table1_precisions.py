"""Paper Table 1: predicted accumulation precisions for CIFAR-10 ResNet 32,
ImageNet ResNet 18 and ImageNet AlexNet, (normal, chunked-64) per
layer/block/role, compared against the published table.

Closed-form analysis (``repro_torch.core``), host arithmetic only; the
output lines are the JAX package's ``benchmarks/table1_precisions.py``.

  PYTHONPATH=src python -m repro_torch.paper.table1_precisions
"""

from __future__ import annotations

from repro_torch.core.acc_lengths import (
    alexnet_imagenet,
    resnet18_imagenet,
    resnet32_cifar,
)
from repro_torch.core.precision import assign_network

PAPER = {
    "CIFAR-10 ResNet 32": {
        ("Conv 0", "FWD"): (6, 5), ("ResBlock 1", "FWD"): (6, 5),
        ("ResBlock 2", "FWD"): (7, 5), ("ResBlock 3", "FWD"): (7, 5),
        ("ResBlock 1", "BWD"): (6, 5), ("ResBlock 2", "BWD"): (7, 5),
        ("ResBlock 3", "BWD"): (8, 5),
        ("Conv 0", "GRAD"): (11, 8), ("ResBlock 1", "GRAD"): (11, 8),
        ("ResBlock 2", "GRAD"): (10, 6), ("ResBlock 3", "GRAD"): (9, 6),
    },
    "ImageNet ResNet 18": {
        ("Conv 0", "FWD"): (9, 6), ("ResBlock 1", "FWD"): (7, 5),
        ("ResBlock 2", "FWD"): (8, 5), ("ResBlock 3", "FWD"): (8, 5),
        ("ResBlock 4", "FWD"): (9, 6),
        ("ResBlock 1", "BWD"): (8, 6), ("ResBlock 2", "BWD"): (9, 6),
        ("ResBlock 3", "BWD"): (9, 6), ("ResBlock 4", "BWD"): (10, 6),
        ("Conv 0", "GRAD"): (15, 10), ("ResBlock 1", "GRAD"): (15, 9),
        ("ResBlock 2", "GRAD"): (12, 8), ("ResBlock 3", "GRAD"): (10, 6),
        ("ResBlock 4", "GRAD"): (9, 5),
    },
    "ImageNet AlexNet": {
        ("Conv 1", "FWD"): (7, 5), ("Conv 2", "FWD"): (9, 5),
        ("Conv 3", "FWD"): (9, 5), ("Conv 4", "FWD"): (8, 5),
        ("Conv 5", "FWD"): (8, 5), ("FC 1", "FWD"): (9, 6),
        ("FC 2", "FWD"): (8, 5),
        ("Conv 2", "BWD"): (8, 5), ("Conv 3", "BWD"): (8, 5),
        ("Conv 4", "BWD"): (10, 8), ("Conv 5", "BWD"): (8, 5),
        ("FC 1", "BWD"): (8, 5), ("FC 2", "BWD"): (8, 5),
        ("Conv 1", "GRAD"): (10, 7), ("Conv 2", "GRAD"): (9, 6),
        ("Conv 3", "GRAD"): (8, 6), ("Conv 4", "GRAD"): (6, 5),
        ("Conv 5", "GRAD"): (6, 5), ("FC 1", "GRAD"): (6, 5),
        ("FC 2", "GRAD"): (6, 5),
    },
}

NETS = {
    "CIFAR-10 ResNet 32": resnet32_cifar,
    "ImageNet ResNet 18": resnet18_imagenet,
    "ImageNet AlexNet": alexnet_imagenet,
}


def run(csv=False):
    rows = []
    grand_tot = grand_w1 = grand_exact = 0
    for net, fn in NETS.items():
        a = assign_network(net, fn(), m_p=5)
        print(f"\n### {net}")
        print(f"{'layer':12s} {'role':5s} {'paper':>9s} {'ours':>9s} {'d':>9s}")
        tot = w1 = ex = 0
        for (layer, role), (pn, pc) in PAPER[net].items():
            on, oc = a.get(layer, role)
            tot += 2
            w1 += (abs(on - pn) <= 1) + (abs(oc - pc) <= 1)
            ex += (on == pn) + (oc == pc)
            mark = "" if abs(on - pn) <= 1 and abs(oc - pc) <= 1 else "  <<"
            print(f"{layer:12s} {role:5s} ({pn:2d},{pc:2d})   ({on:2d},{oc:2d})"
                  f"   ({on - pn:+d},{oc - pc:+d}){mark}")
            rows.append((net, layer, role, pn, pc, on, oc))
        print(f"-> {net}: {ex}/{tot} exact, {w1}/{tot} within +-1 bit "
              f"({100 * w1 / tot:.0f}%)")
        grand_tot += tot
        grand_w1 += w1
        grand_exact += ex
    print(f"\nTOTAL: {grand_exact}/{grand_tot} exact, {grand_w1}/{grand_tot} "
          f"within +-1 bit ({100 * grand_w1 / grand_tot:.0f}%)")
    print("outlier cells are first-layer convs (paper's unstated input-layer "
          "handling) and AlexNet GRAD (needs the paper's measured per-layer "
          "NZR; see llm_precisions.py --invert-nzr for feasibility)")
    return {"within1_pct": 100 * grand_w1 / grand_tot, "rows": len(rows)}


if __name__ == "__main__":
    run()
