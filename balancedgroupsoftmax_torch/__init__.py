"""BAGS detection in PyTorch with hand-written CUDA kernels for the H100.

The port of the JAX package beside it (JAX on the TPU), which stays the
reference and which this package never imports; a reference written as
JAX `path` :line points into it. It serves and trains BAGS Faster R-CNN
R50-FPN on one card: `apis.init_detector` and
`models.detector.FasterRCNN.predict`; `parallel.train.create_train_state` and
`make_train_step` over `FasterRCNN.loss`. The BAGS two-phase recipe runs
through its CLIs, `python -m balancedgroupsoftmax_torch.tools.<name>`:
`gs_partition`, `train` (phase 1, then phase 2 warm-started from it, and
resume), `test_lvis` (with `--tau`) and `eval_lvis`.
"""
