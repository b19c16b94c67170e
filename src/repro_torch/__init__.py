"""PyTorch/CUDA port of the BSA reproduction (``repro``).

Module paths mirror the JAX package: ``repro_torch.core.bsa`` is the
counterpart of ``repro.core.bsa``, ``repro_torch.kernels.bta`` of
``repro.kernels.bta``, and so on.  The port imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.

Entry points (``models.api.model_api(...).init``, ``make_batch``,
``serving.engine.GeometryEngine``) run on ``"cuda"`` unless the caller
passes ``device="cpu"``.  The attention kernels are hand-written CUDA C++
for sm_90a (``csrc/``), built with ``nvcc`` at first use
(``kernels/_build.py``); on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.
"""
