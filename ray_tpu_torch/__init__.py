"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu's device plane.

A package of its own beside ``ray_tpu``: it imports ``torch`` and never
``jax``, and no module of ``ray_tpu``. Modules mirror ``ray_tpu``'s names
(``ray_tpu_torch.ops.attention`` <-> ``ray_tpu.ops.attention``). Entry
points run on the CUDA card unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise.
"""
