"""SE-SSD on PyTorch and CUDA: the port of ``sessd_tpu`` to an NVIDIA H100.

``sessd_tpu`` (JAX, Pallas on a TPU) stays the reference; this package runs
the same detector in PyTorch, with a hand-written Hopper kernel in place of
each Pallas kernel on its path. The layout mirrors ``sessd_tpu``:

- ``ops/``     sparse-conv helpers and the CUDA kernel wrappers (``ops/cuda``)
- ``csrc/``    CUDA C++ sources, built with nvcc at first use on the card
- ``models/``  VFE, all-sparse backbone, SSFA neck, head, detector, predict
- ``core/``    box decode, rotated BEV IoU, rotated NMS, anchors and the
               numpy box helpers of the host layer
- ``data/``    KITTI dataset, augmentation, loader, host rulebooks, AP eval
- ``train/``   losses, optimizer, train step, trainer with validation
- ``tools/``   ``create_data``, ``train`` and ``test`` entry points
- ``utils/``   the C++ host library, checkpoints, synthetic scenes, weight
               conversion from the JAX variables
- ``configs/`` the shipped configs, ``config.py`` their loader
- ``serve.py`` batch-1 / batch-N serving, ``builder.py`` config -> objects

The host layer (voxelizer, C++ rulebooks, data, configs, KITTI eval) is the
port's own copy of the JAX package's JAX-free modules, under the same
names. Nothing in this package imports ``sessd_tpu``, ``jax`` or ``flax``,
and no kernel is built at import.
"""

__version__ = "0.1.0"
