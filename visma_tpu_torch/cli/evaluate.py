"""Quantitative evaluation from a tool.json config (port of
visma_tpu/cli/evaluate.py; reference parity: example/example_evaluate.cpp +
cfg/tool.json). Runs on the CUDA card unless `--device cpu` is given."""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="tool.json (reference cfg/tool.json keys)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from visma_tpu_torch.utils.platform import configure_platform

    device = configure_platform(args.device)

    from visma_tpu_torch.eval import quantitative_evaluation
    from visma_tpu_torch.io import load_json
    from visma_tpu_torch.utils.term import TermColor

    cfg = load_json(args.config)
    metrics = quantitative_evaluation(cfg, device=device)
    for name, m in metrics.items():
        print(TermColor.wrap(f"{name} errors:", TermColor.cyan))
        for k in ("median", "mean", "std", "max", "min"):
            print(f"  {k}={m[k]:.6f}")
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
