"""Run the BAGS ablation matrix on a long-tailed fixture through the port's
CLIs (JAX tools/run_longtail_ablation.py; BAGS_EXPERIMENT.md).

    python -m balancedgroupsoftmax_torch.tools.make_longtail --out /tmp/synlt --train-images 400
    python -m balancedgroupsoftmax_torch.tools.gs_partition --ann /tmp/synlt/train.json \
        --out /tmp/synlt/part.npz --num-classes 49 --thresholds 8 40 200
    python -m balancedgroupsoftmax_torch.tools.run_longtail_ablation --data /tmp/synlt \
        --work-dir /tmp/ablation --epochs 12

The rows, in the JAX tool's order: the plain-softmax baseline trained from
scratch (phase 1); the baseline tested with its classifier tau-normalised
(`--taus`); tau-norm-select on the baseline (`--tau-select`); BAGS, the GS
head warm-started from the baseline with only fc_cls training (phase 2);
and the baseline retrained with repeat-factor sampling, t = 8 / train images
unless `--rfs-t` is given. Each trains with `python -m
balancedgroupsoftmax_torch.tools.train` and tests with `...tools.test_lvis`
in a subprocess on `--device`, then the evaluator scores the val split.
`main(argv, run)` takes another way to run a CLI: chip_smoke.py calls each
CLI's `main(argv)` in its own process, to count and check its kernels.

A row whose checkpoint exists is not trained again, and a row's detections
(`res_<tag>.json`) are reused unless they are older than its checkpoint, so
an interrupted matrix resumes where it stopped. Writes ablation.md and
ablation.json (AP, AP50, APr, APc, APf per row, in %), and train_times.json
(each trained row's steps, seconds and images/s as the train CLI printed
them), into --work-dir.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from ..eval.lvis_eval import LvisEvaluator

PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])
TRAINED = re.compile(r"trained (\d+) steps in ([0-9.]+) s \(([0-9.]+) images/s")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", required=True, help="make_longtail's output directory, with part.npz")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--ft-epochs", type=int, default=None, help="phase-2 epochs (default --epochs)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--scale", type=int, nargs=2, default=(320, 320))
    p.add_argument("--warmup-iters", type=int, default=100)
    p.add_argument("--taus", type=float, nargs="+", default=[0.5, 0.7, 1.0], help="the tau-norm rows")
    p.add_argument("--tau-select", type=float, default=1.0, help="the tnorm-select row's tau")
    p.add_argument("--rfs-t", type=float, default=None,
                   help="RFS threshold t (default 8 / train images: LVIS's 0.001 makes every factor 1 here)")
    p.add_argument("--dtype", default="bfloat16", help="the training compute dtype")
    p.add_argument("--skip", nargs="*", default=[], help="rows to skip: baseline tau tnorm-select gs rfs")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def run_subprocess(name: str, argv: list) -> str:
    """Run the CLI `tools.<name>` with `argv` in a subprocess, its output
    passed through; returns that output."""
    cmd = [sys.executable, "-m", f"balancedgroupsoftmax_torch.tools.{name}", *argv]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [PACKAGE_ROOT, os.environ.get("PYTHONPATH")])))
    lines = []
    with subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            print(line, end="", flush=True)
            lines.append(line)
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return "".join(lines)


def train(args, run, name, model, extra, epochs, times) -> str:
    wd = os.path.join(args.work_dir, name)
    ckpt = os.path.join(wd, f"ckpt_epoch_{epochs}.pt")
    if os.path.exists(ckpt):
        print(f"[{name}] checkpoint exists, skipping train")
        return ckpt
    text = run("train", [
        "--model", model,
        "--ann", os.path.join(args.data, "train.json"),
        "--img-prefix", os.path.join(args.data, "images"),
        "--work-dir", wd, "--batch-size", str(args.batch_size),
        "--lr", str(args.lr), "--epochs", str(epochs),
        "--lr-steps", str(max(epochs - 4, 1)), str(max(epochs - 1, 2)),
        "--warmup-iters", str(args.warmup_iters),
        "--scale", str(args.scale[0]), str(args.scale[1]),
        "--dtype", args.dtype, "--log-interval", "10",
        "--save-interval", "100",  # only the last epoch's checkpoint
        "--device", args.device,
    ] + extra)
    steps, seconds, rate = TRAINED.search(text).groups()
    times[name] = dict(steps=int(steps), seconds=float(seconds), images_per_s=float(rate))
    return ckpt


def evaluate(args, run, name, model, ckpt, extra, tag=None) -> dict:
    # a row's detections are cached under its tag, and re-run when its
    # checkpoint is newer than them
    out = os.path.join(args.work_dir, f"res_{tag or name}.json")
    stale = os.path.exists(out) and os.path.getmtime(out) < os.path.getmtime(ckpt)
    if not os.path.exists(out) or stale:
        run("test_lvis", [
            "--model", model,
            "--ann", os.path.join(args.data, "val.json"),
            "--img-prefix", os.path.join(args.data, "images"),
            "--checkpoint", ckpt, "--batch-size", str(args.batch_size),
            "--scale", str(args.scale[0]), str(args.scale[1]),
            "--out", out, "--no-eval", "--device", args.device,
        ] + extra)
    with open(os.path.join(args.data, "val.json")) as f:
        gt = json.load(f)
    with open(out) as f:
        dets = json.load(f)
    ev = LvisEvaluator(gt, dets)
    ev.run()
    row = {k: round(ev.results[k] * 100, 2) for k in ("AP", "AP50", "APr", "APc", "APf")}
    print(f"[{name}] {row}", flush=True)
    return row


def main(argv=None, run=run_subprocess) -> dict:
    """Returns the rows, {name: {AP, AP50, APr, APc, APf}}. `run(name, argv)`
    runs the CLI `tools.<name>` and returns what it printed."""
    args = parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    part = os.path.join(args.data, "part.npz")
    if not os.path.exists(part):
        raise SystemExit(f"run tools.gs_partition first ({part})")
    ft_epochs = args.ft_epochs or args.epochs
    times_path = os.path.join(args.work_dir, "train_times.json")
    times = json.loads(Path(times_path).read_text()) if os.path.exists(times_path) else {}
    rows = {}

    # 1. the plain-softmax baseline (phase 1)
    base_ckpt = train(args, run, "baseline", "faster_rcnn_r50", ["--selectp", "0"], args.epochs, times)
    if "baseline" not in args.skip:
        rows["baseline"] = evaluate(args, run, "baseline", "faster_rcnn_r50", base_ckpt, [])

    # 2. the baseline's classifier tau-normalised at test time, then the
    #    dual-head tau-norm-select (tail rows rescored by the normalised copy)
    if "tau" not in args.skip:
        for tau in args.taus:
            rows[f"tau={tau}"] = evaluate(args, run, "tau", "faster_rcnn_r50", base_ckpt, ["--tau", str(tau)],
                                          tag=f"tau{tau}")
    if "tnorm-select" not in args.skip:
        rows[f"tnorm-select={args.tau_select}"] = evaluate(
            args, run, "tnorm-select", "faster_rcnn_r50", base_ckpt, ["--tau-select", str(args.tau_select)],
            tag=f"tselect{args.tau_select}",
        )

    # 3. BAGS: the GS head fine-tuned from the baseline (phase 2)
    if "gs" not in args.skip:
        gs_ckpt = train(args, run, "gs", "gs_faster_rcnn_r50",
                        ["--selectp", "1", "--load-from", base_ckpt, "--partition", part], ft_epochs, times)
        rows["gs (BAGS)"] = evaluate(args, run, "gs", "gs_faster_rcnn_r50", gs_ckpt, ["--partition", part], tag="gs")

    # 4. repeat-factor sampling; t scaled to the fixture, or every factor is
    #    1 and the train CLI refuses the no-op sampler
    if "rfs" not in args.skip:
        if args.rfs_t is None:
            with open(os.path.join(args.data, "train.json")) as f:
                n_train = len(json.load(f)["images"])
            args.rfs_t = 8.0 / n_train
            print(f"[rfs] auto-scaled t = 8/{n_train} = {args.rfs_t:.5f}")
        rfs_ckpt = train(args, run, "rfs", "faster_rcnn_r50",
                         ["--selectp", "0", "--use-rfs", "--rfs-t", str(args.rfs_t)], args.epochs, times)
        rows["rfs"] = evaluate(args, run, "rfs", "faster_rcnn_r50", rfs_ckpt, [])

    with open(os.path.join(args.work_dir, "ablation.json"), "w") as f:
        json.dump(rows, f, indent=1)
    with open(times_path, "w") as f:
        json.dump(times, f, indent=1)
    lines = ["| config | AP | AP50 | APr | APc | APf |", "|---|---|---|---|---|---|"]
    for name, r in rows.items():
        lines.append(f"| {name} | {r['AP']:.2f} | {r['AP50']:.2f} | {r['APr']:.2f} | {r['APc']:.2f} | {r['APf']:.2f} |")
    table = "\n".join(lines)
    with open(os.path.join(args.work_dir, "ablation.md"), "w") as f:
        f.write(table + "\n")
    print(table)
    print(f"train times: {json.dumps(times)}")
    return rows


if __name__ == "__main__":
    main()
