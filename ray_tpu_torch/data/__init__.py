"""Port of ``ray_tpu.data``'s consumer side: ``DataIterator`` over numpy
column-dict batches, with the device feed (``iter_torch_batches``)."""
