"""yolo_tpu_torch — the PyTorch + CUDA port of yolo_tpu for NVIDIA Hopper.

Float detection from Darknet cfgs: ``runtime.load_model`` -> ``fuse`` ->
``make_infer`` runs the forward (``models/network.py``), the dense or
sparse decode and the batched NMS (``ops/nms.py``), whose suppression stage
is a CUDA kernel (``csrc/nms_suppress.cu``).

True-int8 serving of google-scheme quantized models:
``load_model(quantized=1)`` -> calibration steps ``apply(x, train=True)``
(the fake-quant sim, ``compress/quant.py``) -> ``make_infer`` runs the int8
engine (``models/int8_engine.py``), every int8 conv of which is a CUDA
kernel (``csrc/conv_int8.cu``), into the sparse NMS on int8 heads.

Kernels are built by ``_build.py`` and have plain PyTorch twins for CPU
tensors. The package keeps its own copies of the cfg IR, parsers,
checkpoint format and CLI helpers (``ir.py``, ``config.py``, ``utils/``,
``data/``), and imports neither jax nor the JAX package ``yolo_tpu``.
"""
