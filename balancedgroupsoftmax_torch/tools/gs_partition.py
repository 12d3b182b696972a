"""Write the BAGS group partition of an LVIS annotation file (JAX
tools/gs_partition.py; the reference's offline tools/lvis_analyse.py step).

    python -m balancedgroupsoftmax_torch.tools.gs_partition --ann ANN --out PART.npz \
        [--num-classes 1231] [--thresholds 10 100 1000]

One `.npz` with label2binlabel, pred_slice, label2logit and label2bin
(`gs/partition.py`), which both packages load. `--thresholds 100` gives the
2-bin ablation, `5 10 50 100 500 1000 5000` the 8-bin one.
"""

from __future__ import annotations

import argparse

from ..gs.partition import partition_from_lvis, save_partition


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ann", required=True, help="LVIS train annotation json")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--num-classes", type=int, default=1231)
    p.add_argument("--thresholds", type=int, nargs="+", default=[10, 100, 1000],
                   help="instance-count bin edges (the paper's 10 100 1000)")
    args = p.parse_args(argv)
    part = partition_from_lvis(args.ann, args.num_classes, tuple(args.thresholds))
    save_partition(args.out, part)
    print(f"wrote {args.out}: {part.num_bins} bins, slice sizes {part.bin_sizes}, {part.num_logits} logits")
    return part


if __name__ == "__main__":
    main()
