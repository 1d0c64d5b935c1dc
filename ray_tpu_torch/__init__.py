"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute path.

A package of its own beside ``ray_tpu``: it imports ``torch`` and never
``jax``, and nothing of ``ray_tpu`` (what it needs, it keeps its own copy
of). The layout mirrors ``ray_tpu`` module for module, so each ported file
has one reference file to be checked against:

* ``ray_tpu_torch.ops.layers``    ← ``ray_tpu.ops.layers``
* ``ray_tpu_torch.ops.attention`` ← ``ray_tpu.ops.attention`` (the three
  Pallas flash-attention kernels become hand-written CUDA C++ for Hopper,
  sources under ``ops/csrc/``, built at first use by ``ops/_build.py``)
* ``ray_tpu_torch.models.llama``  ← ``ray_tpu.models.llama`` (training half)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back.
"""
