"""PyTorch/CUDA port of the BSA reproduction (``repro``).

Module paths mirror the JAX package: ``repro_torch.core.bsa`` is the
counterpart of ``repro.core.bsa``, ``repro_torch.kernels.bta`` of
``repro.kernels.bta``, and so on.  The port imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.

Entry points (``models.api.model_api(...).init``, ``make_batch``,
``serving.engine.GeometryEngine``, ``launch.steps.make_train_step``,
``python -m repro_torch.launch.train_shapenet``) run on ``"cuda"`` unless
the caller asks for the CPU.  The attention kernels, forward and backward,
are hand-written CUDA C++ for sm_90a (``csrc/``), built with ``nvcc`` at
first use (``kernels/_build.py``); on CPU tensors every kernel wrapper runs
its plain PyTorch version instead.
"""
