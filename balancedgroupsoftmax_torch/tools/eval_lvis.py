"""Score a result file with the federated LVIS evaluator (JAX
tools/eval_lvis.py), printing the table `test_lvis` prints.

    python -m balancedgroupsoftmax_torch.tools.eval_lvis --ann ANN --result RESULTS.json
"""

from __future__ import annotations

import argparse
import json

from ..eval.lvis_eval import LvisEvaluator


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ann", required=True)
    p.add_argument("--result", required=True)
    args = p.parse_args(argv)
    with open(args.ann) as f:
        gt = json.load(f)
    with open(args.result) as f:
        dets = json.load(f)
    ev = LvisEvaluator(gt, dets)
    ev.run()
    print("bbox results:")
    ev.print_results()
    return ev


if __name__ == "__main__":
    main()
