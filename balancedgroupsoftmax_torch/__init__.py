"""BAGS detection in PyTorch with hand-written CUDA kernels for the H100.

The port of the JAX package beside it (JAX on the TPU), which stays the
reference and which this package never imports; a reference written as
JAX `path` :line points into it. This slice serves BAGS Faster R-CNN R50-FPN: `apis.init_detector`
and `models.detector.FasterRCNN.predict`.
"""
