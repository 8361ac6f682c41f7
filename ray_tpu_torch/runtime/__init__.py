"""The port's in-process runtime (the local mode of ``ray_tpu/runtime``)."""
