"""yolo_tpu_torch — the PyTorch + CUDA port of yolo_tpu for NVIDIA Hopper.

Float detection from Darknet cfgs: ``runtime.load_model`` -> ``fuse`` ->
``make_infer`` runs the forward (``models/network.py``), the dense or
sparse decode and the batched NMS (``ops/nms.py``), whose suppression stage
is a CUDA kernel (``csrc/nms_suppress.cu``, built by ``_build.py``) with a
plain PyTorch twin for CPU tensors. The cfg IR, cfg parser and checkpoint
format are shared with the JAX package (``yolo_tpu/ir.py``, ``config.py``,
``utils/checkpoint.py``, none of which imports jax); this package never
imports jax.
"""
